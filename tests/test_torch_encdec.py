"""The port's encoder-decoder (whisper-base) against the JAX package's.

fp32 throughout, reduced whisper-base (2 layers of each stack, d 128, 4
heads of 32, decoder cap 32).  The reference's params, drawn from its
key, are carried into the port by ``models.convert.params_from_numpy``
(``enc_layers`` and ``dec_layers`` split layer by layer), and the same
frames and tokens, made by numpy from a seed, go through both.

Tolerances: ``sinusoid`` 1e-5 (two libraries' sin, cos and pow); the
encoder's output, the cross-attention and the caches 1e-5; prefill and
decode logits 2e-4 (the dense LMs' ``LOGIT_TOL``); the loss 1e-5
relative and every gradient leaf 2e-4 * max|g_ref| of its leaf
(``tests/test_torch_lm_train.py``'s).  On the CPU the decoder's causal
self-attention runs the SWA kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro.models import get_config as jget_config
from repro_torch.kernels import swa_attention as tswa
from repro_torch.models import build, get_config, get_model
from repro_torch.models import encdec as tencdec
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import EncDecModel

ARCH = "whisper_base"
TOL = 1e-5
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
DECODE_STEPS = 4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("S,d", [(1, 8), (37, 128), (1500, 512)])
def test_sinusoid_matches_reference(S, d):
    """sin and cos concatenated, not interleaved: the layout against
    float64 numpy within 2e-4 (fp32 angles up to 1,500 rad)."""
    want = jencdec.sinusoid(S, d, jnp.float32)
    got = tencdec.sinusoid(S, d, torch.float32)
    assert tuple(got.shape) == (S, d)
    _close(got, want, TOL)
    ang = np.arange(S)[:, None] / 10000.0 ** (2 * np.arange(d // 2)[None, :]
                                              / d)
    _close(got, np.concatenate([np.sin(ang), np.cos(ang)], -1), 2e-4)


def test_decoder_length_is_the_references():
    for seq in (8, 100, 256, 32_000):
        for cap in (32, 448):
            assert tencdec._dec_len(seq, cap) == jencdec._dec_len(seq, cap)


_RUN: dict = {}


def _run():
    """Both packages' reduced model on the same params: the encoder, a
    prefill and DECODE_STEPS greedy decode steps, the loss and its
    gradients."""
    if _RUN:
        return _RUN
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.key(5))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(6)
    B, S_enc = 2, 96
    dl = tcfg.dec_len_cap                 # the whole decoder, 32 tokens
    P = dl - DECODE_STEPS
    frames = rng.standard_normal((B, S_enc, tcfg.d_model), dtype=np.float32)
    toks = rng.integers(0, tcfg.vocab, (B, dl)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, dl)).astype(np.int32)
    labels[rng.random((B, dl)) < 0.1] = -1
    jmem = jm.encode(params, jnp.asarray(frames))
    tmem = tm.encode(torch.from_numpy(frames))
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :P])}
    tb = {"frames": torch.from_numpy(frames),
          "tokens": torch.from_numpy(toks[:, :P])}
    jl, jc = jm.prefill(params, jb)
    tswa.reset_launches()
    tl, tc = tm.prefill(tb)
    caches = {k: (np.asarray(jc[k]), tc[k].clone().numpy()) for k in jc}
    steps = []
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(DECODE_STEPS):
        jd, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(P + i, jnp.int32))
        td, tc = tm.decode_step(tc, torch.from_numpy(tok), P + i)
        steps.append((np.asarray(jd), td.numpy()))
        tok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    batch = {"frames": frames, "tokens": toks, "labels": labels}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    tm._p().requires_grad_(True)
    tloss, tmet = tm.loss(jax.tree.map(torch.from_numpy, batch))
    tloss.backward()
    _RUN.update({
        "model": tm, "P": P, "mem": (np.asarray(jmem),
                                     tmem.detach().numpy()),
        "prefill": (np.asarray(jl), tl.numpy()), "caches": caches,
        "steps": steps,
        "loss": (float(jloss), float(tloss.detach())),
        "aux": float(tmet["aux"]),
        "jgrads": jax.tree.map(np.asarray, jg),
        "tgrads": {n: t.grad.numpy()
                   for n, t in tm.params.named_parameters()}})
    return _RUN


def test_zoo_builds_whisper():
    for reduced in (False, True):
        cfg, model = get_model("whisper-base", reduced=reduced)
        assert isinstance(model, EncDecModel) and cfg.family == "audio"
        assert not model.supports_long_context()
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.dec_len_cap) == (6, 512,
                                                                   64, 448)


def test_encode_matches_reference():
    want, got = _run()["mem"]
    assert got.shape == want.shape
    _close(got, want, TOL)


def test_cross_attention_matches_reference():
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    p = jax.tree.map(np.asarray, jencdec._dec_layer_init(jax.random.key(7),
                                                         jcfg)["xattn"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, jcfg.d_model), dtype=np.float32)
    mem = rng.standard_normal((2, 41, jcfg.d_model), dtype=np.float32)
    want = jencdec.cross_attn_apply(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), jnp.asarray(mem), jcfg)
    got = tencdec.cross_attn_apply(jax.tree.map(torch.from_numpy, p),
                                   torch.from_numpy(x),
                                   torch.from_numpy(mem), tcfg)
    _close(got, want, TOL)


def test_prefill_logits_and_caches_match_reference():
    """The self-attention cache is dec_len_cap long whatever the prompt,
    its headroom zero; the cross-attention cache holds the encoder's
    memory."""
    r = _run()
    want, got = r["prefill"]
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    cap = get_config(ARCH, True).dec_len_cap
    for name, (jc, tc) in r["caches"].items():
        assert tc.shape == jc.shape, name
        _close(tc, jc, TOL)
    assert r["caches"]["k"][1].shape[3] == cap
    assert not r["caches"]["k"][1][:, :, :, r["P"]:].any()


def test_greedy_decode_matches_reference():
    for i, (want, got) in enumerate(_run()["steps"]):
        _close(got, want, LOGIT_TOL)
        assert np.array_equal(got.argmax(-1), want.argmax(-1)), i


def test_loss_matches_reference():
    r = _run()
    want, got = r["loss"]
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert r["aux"] == 0.0


def test_every_gradient_leaf_matches_reference():
    """Each stacked reference leaf of ``enc_layers`` and ``dec_layers``
    against the port's per-layer leaves; every leaf has a gradient."""
    r = _run()
    flat = jax.tree_util.tree_flatten_with_path(r["jgrads"])[0]
    seen = set()
    for path, ref in flat:
        keys = [k.key for k in path]
        scale = np.abs(ref).max()
        assert scale > 0, keys
        if keys[0] in ("enc_layers", "dec_layers"):
            names = [(f"{keys[0]}.{i}.{'.'.join(keys[1:])}", ref[i])
                     for i in range(ref.shape[0])]
        else:
            names = [(".".join(keys), ref)]
        for name, want in names:
            np.testing.assert_allclose(r["tgrads"][name], want, rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=name)
            seen.add(name)
    assert seen == set(r["tgrads"])


def test_specs_match_reference():
    jm, tm = jbuild(jget_config(ARCH)), build(get_config(ARCH))
    for seq in (256, 1500, 32_000):
        j, t = jm.batch_spec(2, seq), tm.batch_spec(2, seq)
        assert list(t) == list(j)
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}
        assert t["frames"].dtype == torch.bfloat16
        assert t["tokens"].dtype == torch.int32
        j, t = jm.cache_spec(2, seq), tm.cache_spec(2, seq)
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}


def test_decode_past_the_cap_and_a_long_prompt_raise():
    r = _run()
    model = r["model"]
    cfg = model.cfg
    frames = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(ValueError, match="dec_len_cap"):
        model.prefill({"frames": frames, "tokens": torch.zeros(
            (1, cfg.dec_len_cap + 1), dtype=torch.int32)})
    _, cache = model.prefill({"frames": frames, "tokens": torch.zeros(
        (1, 4), dtype=torch.int32)})
    with pytest.raises(ValueError, match="dec_len_cap"):
        model.decode_step(cache, torch.zeros((1, 1), dtype=torch.int32),
                          cfg.dec_len_cap)


def test_launch_generate_feeds_frames_and_holds_the_cap():
    from repro_torch.launch import generate
    out = generate.main(["--arch", "whisper-base", "--reduced", "--device",
                         "cpu", "--frames", "40", "--prompt-len", "12",
                         "--steps", "4"])
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 5) and out["frames"] == 40
    assert ((ids >= 0) & (ids < get_config(ARCH, True).padded_vocab)).all()
    assert out["swa_launches_prefill"] == 0        # the plain path here
    with pytest.raises(SystemExit, match="cap"):
        generate.main(["--arch", "whisper-base", "--reduced", "--device",
                       "cpu", "--prompt-len", "30", "--steps", "3"])


def test_launch_train_whisper_first_loss_matches_reference(monkeypatch):
    """``launch.train --arch whisper-base --reduced --device cpu`` in fp32
    (the config module's ``REDUCED`` swapped for its fp32 copy), from the
    reference's params: its first loss is the reference's ``model.loss`` on
    the batch ``repro.launch.train.train_lm`` draws first from the same
    seed (frames, then tokens and labels, in batch_spec's order)."""
    from repro_torch.configs import whisper_base as mod
    from repro_torch.launch import train as tlaunch
    monkeypatch.setattr(mod, "REDUCED", mod.REDUCED.with_(dtype="float32"))
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = {}
    for k, v in jm.batch_spec(2, 128).items():
        if v.dtype == jnp.int32:
            batch[k] = jnp.asarray(rng.integers(0, jcfg.vocab, v.shape),
                                   jnp.int32)
        else:
            batch[k] = jnp.asarray(rng.normal(size=v.shape), v.dtype)
    want = float(jm.loss(params, batch)[0])
    out = tlaunch.train_lm("whisper-base", reduced=True, steps=2, batch=2,
                           seq=128, seed=0, device="cpu",
                           params=jax.tree.map(np.asarray, params))
    assert out["losses"][0] == pytest.approx(want, rel=LOSS_RTOL)
    assert all(np.isfinite(out["losses"]))


@pytest.mark.cuda
def test_reduced_whisper_runs_the_causal_kernel_on_card():
    """Reduced whisper on the card in fp32: one SWA forward a decoder layer
    of the prefill, logits within 2e-4 of the CPU plain path on the same
    params; skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    model = build(tcfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.standard_normal((2, 50, tcfg.d_model),
                                                  dtype=np.float32))
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 20)).astype(
        np.int32))
    logits = {}
    for dev in ("cpu", "cuda"):
        model.params.to(dev)
        tswa.reset_launches()
        out, cache = model.prefill({"frames": frames.to(dev),
                                    "tokens": toks.to(dev)})
        step, _ = model.decode_step(cache, toks[:, -1:].to(dev), 20)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tswa.launches["swa_attention_forward"] == tcfg.n_layers
        logits[dev] = (out.cpu().numpy(), step.cpu().numpy())
    for got, want in zip(logits["cuda"], logits["cpu"]):
        _close(got, want, LOGIT_TOL)
