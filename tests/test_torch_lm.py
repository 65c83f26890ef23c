"""The port's dense and MoE LMs against the JAX package's.

Each dense and MoE arch's ``REDUCED`` config runs in fp32 in both packages
(``cfg.with_(dtype="float32")``, as ``tests/test_arch_consistency.py``
does): the reference's params, drawn from its key, are carried into the
port by ``models.convert.params_from_numpy``, and the same token ids, made
by numpy from a seed, go through both.  Tolerances: last prefill logits
and decode logits within 2e-4, caches within 1e-5 (fp32 sums in another
order), greedy ids equal; the port's own prefill/decode consistency
within 2e-3, the reference's ``TOL`` (the MoE archs there at capacity
factor 16, as ``test_arch_consistency.py`` runs them: dropping depends on
which tokens share a prefill).  h2o-danube's prompt is 80 tokens, which
wraps its reduced window of 64 as ``test_arch_consistency.py`` does; the
full-attention archs use 48.  On the CPU every causal attention layer
(sliding-window, or full as a window over every key) runs the kernel's
plain version; the ``cuda`` test at the end runs the kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import swa_attention as tswa
from repro_torch.launch import generate
from repro_torch.models import ARCH_IDS, build, get_config
from repro_torch.models import attention as tattention
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import ParamTree
from repro_torch.models.lm import cache_leaves
from repro_torch.models.steps import make_prefill_step, make_serve_step
from repro_torch.models.zoo import FAMILIES

LOGIT_TOL = 2e-4
CACHE_TOL = 1e-5
CONSISTENCY_TOL = 2e-3
DECODE_STEPS = 8
#: (arch, kv_groups): the dense and MoE archs; h2o-danube with its KV
#: heads repeated to 4 groups and, at 8 groups, its q heads padded 4 -> 8;
#: olmoe's q heads padded 4 -> 8, grok's KV heads repeated 2 -> 4
#: the decoder-only token LMs (the dense and MoE families); the SSM, audio
#: and VLM archs have their own files (test_torch_mamba.py,
#: test_torch_encdec.py, test_torch_vlm.py)
LM_ARCHS = tuple(a for a in ARCH_IDS
                 if get_config(a).family in ("dense", "moe"))
CASES = [(a, 0) for a in LM_ARCHS] + [("h2o_danube_1_8b", 4),
                                      ("h2o_danube_1_8b", 8),
                                      ("olmoe_1b_7b", 8),
                                      ("grok_1_314b", 4)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _cfgs(arch, kv_groups=0):
    jcfg = jget_config(arch, reduced=True).with_(dtype="float32",
                                                  kv_groups=kv_groups)
    tcfg = get_config(arch, reduced=True).with_(dtype="float32",
                                                 kv_groups=kv_groups)
    return jcfg, tcfg


_RUNS: dict = {}


def _run(arch, kv_groups):
    """Both packages' prefill and eight greedy decode steps from the same
    params and prompt, computed once per case (every test of this file
    runs in one worker)."""
    key = (arch, kv_groups)
    if key in _RUNS:
        return _RUNS[key]
    jcfg, tcfg = _cfgs(arch, kv_groups)
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.key(1))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    S = 80 if tcfg.attention == "sliding_window" else 48
    toks = np.random.default_rng(len(arch) + kv_groups).integers(
        0, tcfg.vocab, (2, S)).astype(np.int32)
    cache_len = S + DECODE_STEPS
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks)},
                        cache_len=cache_len)
    out = {"S": S, "toks": toks, "model": tm, "jl": np.asarray(jl),
           "tl": tl.numpy(), "jc": jax.tree.map(np.asarray, jc),
           "tc": {k: v.clone().numpy() for k, v in tc.items()}}
    jstep = jax.jit(jm.decode_step)
    jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    steps = []
    for i in range(DECODE_STEPS):
        jl, jc = jstep(params, jc, jnp.asarray(jtok), jnp.asarray(S + i,
                                                                  jnp.int32))
        tl, tc = tm.decode_step(tc, ttok, S + i)
        steps.append((np.asarray(jl), tl.numpy()))
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32)
    out["steps"] = steps
    _RUNS[key] = out
    return out


def _case_id(c):
    return f"{c[0]}-g{c[1]}"


# ------------------------------ configs ------------------------------- #
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_copies(arch, reduced):
    j = dataclasses.asdict(jget_config(arch, reduced))
    t = dataclasses.asdict(get_config(arch, reduced))
    assert t == j
    assert get_config(arch, reduced).n_params() == \
        jget_config(arch, reduced).n_params()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).n_heads])
def test_every_ported_head_dim_is_a_kernel_head_dim(arch, reduced):
    """Every ported arch with attention runs its causal attention on the
    SWA kernel (a window over every key where it has none), which is
    built for the head dims in ``HEAD_DIMS``."""
    assert get_config(arch, reduced).hd in tswa.HEAD_DIMS


def test_h2o_danube_is_about_1_8b_params():
    cfg = get_config("h2o-danube-1.8b")
    assert 1.7e9 < cfg.n_params() < 1.9e9
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.window) == (24, 2560, 80,
                                                              4096)
    assert cfg.jdtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_cache_specs_match(arch):
    assert {n: dataclasses.asdict(s) for n, s in tshapes.SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in jshapes.SHAPES.items()}
    for name in tshapes.SHAPES:
        assert tshapes.applicable(get_config(arch), tshapes.SHAPES[name]) == \
            jshapes.applicable(jget_config(arch), jshapes.SHAPES[name])
    jm, tm = jbuild(jget_config(arch)), build(get_config(arch))
    for seq in (1_000, 1_000_000):
        # a dict of arrays, or the hybrid's nested dict of tuples of them
        j, t = jm.cache_spec(2, seq), tm.cache_spec(2, seq)
        assert {k: [x.shape for x in jax.tree.leaves(v)]
                for k, v in j.items()} == \
            {k: [tuple(x.shape) for x in cache_leaves(v)]
             for k, v in t.items()}
    assert tm.supports_long_context() == jm.supports_long_context()


def test_unported_families_raise_naming_the_roadmap():
    """Every arch and family of the reference's zoo is ported: the port's
    ``ARCH_IDS`` are the reference's, and only an unknown arch or family
    raises."""
    assert sorted(ARCH_IDS) == sorted(jzoo.ARCH_IDS)
    assert set(FAMILIES) == set(jzoo.FAMILIES)
    with pytest.raises(NotImplementedError, match="family"):
        build(get_config("qwen2-72b").with_(family="no-such-family"))
    with pytest.raises(ValueError):
        get_config("no-such-arch")


# ------------------------------ layers -------------------------------- #
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    p = {"scale": rng.standard_normal(48, dtype=np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(48, dtype=np.float32)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    p = {n: {"w": rng.standard_normal(s, dtype=np.float32) / 6}
         for n, s in (("up", (32, 64)), ("down", (64, 32)),
                      ("gate", (32, 64)))}
    if act == "gelu":
        del p["gate"]
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = tlayers.mlp(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
                      act)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("batched_pos", [False, True])
def test_rope_rotates_interleaved_pairs_as_jax(batched_pos):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 9, 2, 3, 16), dtype=np.float32)
    k = rng.standard_normal((2, 9, 2, 16), dtype=np.float32)
    pos = np.arange(9) + 70
    if batched_pos:
        pos = np.stack([pos, pos + 5])
    jq, jk = jlayers.rope_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                             jnp.asarray(pos), 10_000.0)
    tq, tk = tlayers.rope_qk(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(pos), torch.from_numpy(pos),
                             10_000.0)
    _close(tq, jq, 1e-5)
    _close(tk, jk, 1e-5)


# ------------------------------ blocks -------------------------------- #
def _block_params(arch, kv_groups=0):
    jcfg, tcfg = _cfgs(arch, kv_groups)
    p = jblocks.block_init(jax.random.key(4), jcfg)
    tp = ParamTree(jax.tree.map(lambda a: torch.tensor(np.asarray(a)), p))
    return jcfg, tcfg, p, tp


@pytest.mark.parametrize("arch,kv_groups", [("h2o_danube_1_8b", 0),
                                            ("h2o_danube_1_8b", 8),
                                            ("qwen2_72b", 0)])
def test_block_apply_and_prefill_match_jax(arch, kv_groups):
    jcfg, tcfg, p, tp = _block_params(arch, kv_groups)
    window = jcfg.window if jcfg.attention == "sliding_window" else None
    x = np.random.default_rng(5).standard_normal((2, 70, jcfg.d_model),
                                                 dtype=np.float32)
    want = jblocks.block_apply(p, jnp.asarray(x), jcfg, window=window)
    got = tblocks.block_apply(tp, torch.from_numpy(x), tcfg, window=window)
    _close(got, want, LOGIT_TOL)
    jy, jk, jv = jblocks.block_prefill(p, jnp.asarray(x), jcfg, window=window)
    ty, tk, tv = tblocks.block_prefill(tp, torch.from_numpy(x), tcfg,
                                       window=window)
    _close(ty, jy, LOGIT_TOL)
    _close(tk, jk, CACHE_TOL)
    _close(tv, jv, CACHE_TOL)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "qwen2_72b"])
def test_block_decode_matches_jax(arch):
    """Per-layer caches: the new slot is written in place at pos % W."""
    jcfg, tcfg, p, tp = _block_params(arch)
    window = jcfg.window if jcfg.attention == "sliding_window" else None
    rng = np.random.default_rng(6)
    Sc = window or 90
    x = rng.standard_normal((2, 1, jcfg.d_model), dtype=np.float32)
    kc = rng.standard_normal((2, jcfg.groups, Sc, jcfg.hd), dtype=np.float32)
    vc = rng.standard_normal((2, jcfg.groups, Sc, jcfg.hd), dtype=np.float32)
    pos = 85
    jy, jk, jv = jblocks.block_decode(p, jnp.asarray(x), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(pos), jcfg,
                                      window=window)
    ty, tk, tv = tblocks.block_decode(tp, torch.from_numpy(x),
                                      torch.from_numpy(kc.copy()),
                                      torch.from_numpy(vc.copy()), pos, tcfg,
                                      window=window)
    _close(ty, jy, LOGIT_TOL)
    _close(tk, jk, CACHE_TOL)
    _close(tv, jv, CACHE_TOL)


@pytest.mark.parametrize("q_offset", [0, 37])
def test_causal_attention_runs_on_the_swa_kernel(q_offset, monkeypatch):
    """Full causal attention goes through the SWA kernel's wrapper with a
    window over every key, and equals ``chunked_attention(causal=True)``
    within 2e-4: at the attention level (keys from 0 to q_offset + Sq) and
    through ``attn_apply`` (qwen2's reduced block, Sk = Sq)."""
    calls = []
    real = tswa.swa_attention_forward

    def spy(q, k, v, window, q_offset=0, **kw):
        calls.append((window, q_offset))
        return real(q, k, v, window, q_offset, **kw)

    monkeypatch.setattr(tswa, "swa_attention_forward", spy)
    rng = np.random.default_rng(8 + q_offset)
    B, Sq, G, H, hd = 2, 40, 2, 3, 16
    Sk = q_offset + Sq
    q = torch.from_numpy(rng.standard_normal((B, Sq, G, H, hd),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, G, hd),
                                                 dtype=np.float32))
            for _ in range(2))
    got = tblocks._causal_attention(q, k, v, q_offset)
    assert calls == [(Sk, q_offset)]
    _close(got, tattention.chunked_attention(q, k, v, causal=True,
                                             q_offset=q_offset), 2e-4)

    jcfg, tcfg, _, tp = _block_params("qwen2_72b")
    x = torch.from_numpy(rng.standard_normal((2, Sq, tcfg.d_model),
                                             dtype=np.float32))
    calls.clear()
    got = tblocks.attn_apply(tp["attn"], x, tcfg, causal=True,
                             q_offset=q_offset)
    assert calls == [(q_offset + Sq, q_offset)]
    monkeypatch.setattr(tblocks, "_causal_attention",
                        lambda q, k, v, off: tattention.chunked_attention(
                            q, k, v, causal=True, q_offset=off))
    want = tblocks.attn_apply(tp["attn"], x, tcfg, causal=True,
                              q_offset=q_offset)
    assert len(calls) == 1
    _close(got, want, 2e-4)


# --------------------------- the whole LM ----------------------------- #
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_logits_match_jax(case):
    r = _run(*case)
    assert r["tl"].shape == r["jl"].shape
    _close(r["tl"], r["jl"], LOGIT_TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_caches_match_jax(case):
    """The stacked (L, B, G, Sc, hd) caches, including the rolled SWA
    layout (slot = pos % W) and the zero headroom of full attention."""
    r = _run(*case)
    for name in ("k", "v"):
        assert r["tc"][name].shape == r["jc"][name].shape
        _close(r["tc"][name], r["jc"][name], CACHE_TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_greedy_decode_matches_jax(case):
    r = _run(*case)
    for i, (jl, tl) in enumerate(r["steps"]):
        _close(tl, jl, LOGIT_TOL)
        assert np.array_equal(tl.argmax(-1), jl.argmax(-1)), f"step {i}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_then_decode_equals_longer_prefill(case):
    """prefill(tokens[:, :S]) last logits == prefill(tokens[:, :S-1]) +
    decode_step(token S-1): the port's KV cache write/read path, RoPE at
    absolute positions and the rolling SWA buffer."""
    r = _run(*case)
    model, toks, S = r["model"], torch.from_numpy(r["toks"]), r["S"]
    if model.cfg.moe is not None:
        # the same params at no-drop capacity: which (token, slot) pairs a
        # capacity drops depends on the tokens a prefill holds
        params, cfg = model.params, model.cfg
        model = build(cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0)))
        model.params = params
    full, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :-1]}, cache_len=S)
    dec, _ = model.decode_step(cache, toks[:, -1:], S - 1)
    _close(dec, full, CONSISTENCY_TOL)


def test_steps_greedy_sample_int32_tokens():
    r = _run("h2o_danube_1_8b", 0)
    model, toks = r["model"], torch.from_numpy(r["toks"])
    logits, cache = make_prefill_step(model)({"tokens": toks})
    tok = logits.argmax(-1).to(torch.int32)
    nxt, cache = make_serve_step(model)(cache, tok, r["S"])
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert np.array_equal(nxt.numpy(), r["steps"][0][1].argmax(-1))


@pytest.mark.parametrize("bad", ["missing", "extra", "shape", "layers"])
def test_params_from_numpy_rejects_mismatched_trees(bad):
    jcfg, tcfg = _cfgs("qwen2_72b")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    if bad == "missing":
        del tree["layers"]["attn"]["wq"]["b"]
    elif bad == "extra":
        tree["ln_f"]["bias"] = np.zeros(tcfg.d_model, np.float32)
    elif bad == "shape":
        tree["lm_head"] = tree["lm_head"].T
    elif bad == "layers":
        tree["layers"]["ln1"]["scale"] = tree["layers"]["ln1"]["scale"][:1]
    with pytest.raises((KeyError, ValueError)):
        params_from_numpy(build(tcfg), tree, "cpu")


def test_a_model_without_params_says_so():
    with pytest.raises(RuntimeError, match="params"):
        build(get_config("h2o-danube-1.8b", True)).prefill(
            {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


# ----------------------------- launcher ------------------------------- #
def test_generate_runs_reduced_on_cpu(capsys):
    out = generate.main(["--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "70", "--steps", "5", "--seed", "3"])
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 6)
    assert ((ids >= 0) & (ids < get_config("h2o-danube-1.8b",
                                           True).padded_vocab)).all()
    assert out["swa_launches_prefill"] == 0     # the plain path on the CPU
    assert "continuation ids" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["generate", "params_from_numpy"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "generate":
            generate.main(["--reduced", "--steps", "1"])
        else:
            jcfg, tcfg = _cfgs("h2o_danube_1_8b")
            params_from_numpy(build(tcfg), jax.tree.map(
                np.asarray, jbuild(jcfg).init(jax.random.key(0))))


@pytest.mark.cuda
def test_reduced_h2o_runs_the_kernel_on_card():
    """Reduced h2o-danube on the card: one SWA launch per layer of the
    prefill, logits within 2e-4 of the CPU plain path; skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    r = _run("h2o_danube_1_8b", 0)
    jcfg, tcfg = _cfgs("h2o_danube_1_8b")
    model = build(tcfg)
    params_from_numpy(model, jax.tree.map(
        np.asarray, jbuild(jcfg).init(jax.random.key(1))), "cuda")
    tswa.reset_launches()
    logits, _ = model.prefill({"tokens": torch.from_numpy(r["toks"]).cuda()})
    torch.cuda.synchronize()
    assert tswa.launches["swa_attention_forward"] == tcfg.n_layers
    _close(logits.cpu(), r["tl"], LOGIT_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_normal_draws_the_scaled_values_bit_for_bit(dtype):
    """``layers.normal`` scales its fp32 draw in place (one fp32 transient
    a leaf): the same bits as ``(randn * scale).to(dtype)`` from the same
    seed."""
    got = tlayers.normal(torch.Generator().manual_seed(7), (33, 65), 0.37,
                         dtype)
    want = (torch.randn((33, 65), generator=torch.Generator().manual_seed(7),
                        dtype=torch.float32) * 0.37).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_launch_generate_cuts_the_depth():
    """``launch.generate --layers`` builds the arch cut to that many
    layers: its cache is that many layers deep."""
    base = ["--arch", "qwen2-72b", "--reduced", "--device", "cpu",
            "--prompt-len", "8", "--steps", "2"]
    two, three = generate.main(base), generate.main(base + ["--layers", "3"])
    assert (two["layers"], three["layers"]) == (2, 3)
    assert three["cache_bytes"] * 2 == two["cache_bytes"] * 3
    with pytest.raises(SystemExit, match="--layers"):
        generate.main(base + ["--layers", "0"])
