"""The port's VLM (llava-next-34b's language backbone) against the JAX
package's.

fp32 throughout, reduced llava-next-34b (2 layers, d 256, 4 q heads over
2 kv heads, 16 image tokens).  The reference's params, drawn from its
key, are carried into the port by ``models.convert.params_from_numpy``,
and the same image embeddings and tokens, made by numpy from a seed, go
through both.  ``embed_batch`` puts the image embeddings before the text;
prefill runs over both (full causal attention, on the SWA kernel's plain
version here); decode starts at position ``S_img + P``; the loss runs
over the text positions only.

Tolerances: prefill and decode logits 2e-4, caches 1e-5, the loss 1e-5
relative, every gradient leaf 2e-4 * max|g_ref| of its leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro_torch.kernels import swa_attention as tswa
from repro_torch.models import build, get_config, get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.dense import DenseLM
from repro_torch.models.vlm import VLM

ARCH = "llava_next_34b"
CACHE_TOL = 1e-5
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
DECODE_STEPS = 4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


_RUN: dict = {}


def _run():
    if _RUN:
        return _RUN
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.key(3))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(4)
    B, P, S_img = 2, 24, tcfg.n_frontend_tokens
    img = rng.standard_normal((B, S_img, tcfg.d_model), dtype=np.float32)
    toks = rng.integers(0, tcfg.vocab, (B, P)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, P)).astype(np.int32)
    labels[rng.random((B, P)) < 0.1] = -1
    pos = S_img + P
    cache_len = pos + DECODE_STEPS
    jx = jm.embed_batch(params, {"tokens": jnp.asarray(toks),
                                 "image_embeds": jnp.asarray(img)})
    tx = tm.embed_batch({"tokens": torch.from_numpy(toks),
                         "image_embeds": torch.from_numpy(img)})
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                 "image_embeds": jnp.asarray(img)},
                        cache_len=cache_len)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks),
                         "image_embeds": torch.from_numpy(img)},
                        cache_len=cache_len)
    caches = {k: (np.asarray(jc[k]), tc[k].clone().numpy()) for k in jc}
    steps = []
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(DECODE_STEPS):
        jd, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(pos + i, jnp.int32))
        td, tc = tm.decode_step(tc, torch.from_numpy(tok), pos + i)
        steps.append((np.asarray(jd), td.numpy()))
        tok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    batch = {"tokens": toks, "labels": labels, "image_embeds": img}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    tm._p().requires_grad_(True)
    tloss, _ = tm.loss(jax.tree.map(torch.from_numpy, batch))
    tloss.backward()
    _RUN.update({
        "model": tm, "toks": toks, "img": img, "pos": pos,
        "embed": (np.asarray(jx), tx.detach().numpy()),
        "prefill": (np.asarray(jl), tl.numpy()), "caches": caches,
        "steps": steps, "loss": (float(jloss), float(tloss.detach())),
        "jgrads": jax.tree.map(np.asarray, jg),
        "tgrads": {n: t.grad.numpy()
                   for n, t in tm.params.named_parameters()}})
    return _RUN


def test_zoo_builds_llava():
    for reduced in (False, True):
        cfg, model = get_model("llava-next-34b", reduced=reduced)
        assert isinstance(model, VLM) and isinstance(model, DenseLM)
        assert cfg.family == "vlm"
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.n_frontend_tokens) == (60, 7168, 56, 8, 128, 2880)
    assert 34.3e9 < cfg.n_params() < 34.5e9          # 68.8 GB in bf16


def test_embed_batch_puts_the_image_before_the_text():
    r = _run()
    want, got = r["embed"]
    assert got.shape == (2, r["img"].shape[1] + r["toks"].shape[1],
                         r["img"].shape[2])
    _close(got, want, 0)
    _close(got[:, :r["img"].shape[1]], r["img"], 0)


def test_prefill_logits_and_caches_match_reference():
    """The cache covers the image and text positions plus the decode
    headroom."""
    r = _run()
    want, got = r["prefill"]
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    for name, (jc, tc) in r["caches"].items():
        assert tc.shape == jc.shape, name
        assert tc.shape[3] == r["pos"] + DECODE_STEPS
        _close(tc, jc, CACHE_TOL)


def test_decode_after_the_image_tokens_matches_reference():
    """Decode from position S_img + P: each step's logits and argmax."""
    for i, (want, got) in enumerate(_run()["steps"]):
        _close(got, want, LOGIT_TOL)
        assert np.array_equal(got.argmax(-1), want.argmax(-1)), i


def test_decode_from_the_text_length_alone_differs():
    """The decode position counts the image tokens: decoding at P (as if
    there were no image) gives other logits than at S_img + P."""
    r = _run()
    model = r["model"]
    batch = {"tokens": torch.from_numpy(r["toks"]),
             "image_embeds": torch.from_numpy(r["img"])}
    tok = torch.from_numpy(r["prefill"][1].argmax(-1).astype(np.int32))
    with torch.no_grad():
        _, c1 = model.prefill(batch, cache_len=r["pos"] + 1)
        right, _ = model.decode_step(c1, tok, r["pos"])
        _, c2 = model.prefill(batch, cache_len=r["pos"] + 1)
        wrong, _ = model.decode_step(c2, tok, r["toks"].shape[1])
    _close(right, r["steps"][0][0], LOGIT_TOL)
    assert np.abs(wrong.numpy() - right.numpy()).max() > 1e-3


def test_loss_runs_over_text_positions_and_matches_reference():
    want, got = _run()["loss"]
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_every_gradient_leaf_matches_reference():
    r = _run()
    flat = jax.tree_util.tree_flatten_with_path(r["jgrads"])[0]
    seen = set()
    for path, ref in flat:
        keys = [k.key for k in path]
        scale = np.abs(ref).max()
        assert scale > 0, keys
        if keys[0] == "layers":
            names = [(f"layers.{i}.{'.'.join(keys[1:])}", ref[i])
                     for i in range(ref.shape[0])]
        else:
            names = [(".".join(keys), ref)]
        for name, want in names:
            np.testing.assert_allclose(r["tgrads"][name], want, rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=name)
            seen.add(name)
    assert seen == set(r["tgrads"])


@pytest.mark.parametrize("seq", [8, 40, 6000])
def test_batch_spec_matches_reference(seq):
    """Half the sequence (at most n_frontend_tokens) is image, in the
    reference's key order."""
    for reduced in (False, True):
        jm = jbuild(jget_config(ARCH, reduced))
        tm = build(get_config(ARCH, reduced))
        j, t = jm.batch_spec(2, seq), tm.batch_spec(2, seq)
        assert list(t) == list(j)
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}


def test_launch_generate_feeds_image_embeddings():
    from repro_torch.launch import generate
    out = generate.main(["--arch", "llava-next-34b", "--reduced", "--device",
                         "cpu", "--prompt-len", "10", "--steps", "3"])
    cfg = get_config(ARCH, True)
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 4) and out["image_tokens"] == cfg.n_frontend_tokens
    assert ((ids >= 0) & (ids < cfg.padded_vocab)).all()
    # the cache holds image + text + the decode steps
    assert out["cache_bytes"] == 2 * cfg.n_layers * 2 * cfg.groups * (
        cfg.n_frontend_tokens + 10 + 3) * cfg.hd * 2


@pytest.mark.cuda
def test_reduced_llava_runs_the_causal_kernel_on_card():
    """Reduced llava on the card in fp32: one SWA forward a layer of the
    prefill over image and text, logits within 2e-4 of the CPU plain path
    on the same params; skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    r = _run()
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    tree = jax.tree.map(np.asarray, jbuild(jget_config(
        ARCH, reduced=True).with_(dtype="float32")).init(jax.random.key(3)))
    model = params_from_numpy(build(tcfg), tree, "cuda")
    batch = {"tokens": torch.from_numpy(r["toks"]).cuda(),
             "image_embeds": torch.from_numpy(r["img"]).cuda()}
    tswa.reset_launches()
    out, _ = model.prefill(batch, cache_len=r["pos"] + 1)
    torch.cuda.synchronize()
    assert tswa.launches["swa_attention_forward"] == tcfg.n_layers
    _close(out.cpu(), r["prefill"][1], LOGIT_TOL)
