"""The port's int8 KV cache against the JAX package's.

- ``quantize_kv`` / ``dequantize_kv`` bit-equal to the reference's on the
  same rows: random ones of several magnitudes, all-zero ones, and rows
  whose quotients lie exactly half-way between two integers (both round
  half to even), from fp32 and bf16.
- Reduced qwen2 and h2o-danube (full and sliding-window attention), fp32,
  ``kv_cache_dtype="int8"``, on the reference's params and the same
  tokens.  Prefill: the last logits within 1e-5; the int8 cache equal to
  the port's own ``quantize_kv`` of its fp cache, bit for bit; against
  the reference's int8 cache, the scales within 1e-5 relative and the
  int8 values equal except where the reference's quotient ``t / scale``
  lies within 1e-3 of a rounding boundary (the fp caches the two packages
  quantize differ by up to ~5e-6, which moves such a value across it;
  those entries are counted, printed, and may differ by 1).  Decode, on
  the reference's own int8 cache each step: logits within 1e-5, every
  slot but the new one left bit for bit, the new slot under the prefill's
  rule (its boundary read from the port's unquantized k and v, which lie
  within ~1e-6 of the reference's).
- Against the port's fp cache, the contract of
  ``tests/test_int8_kv_cache.py``: logits within rtol 0.1, atol 0.15, the
  same top-1.
- ``cache_spec``: int8 values and fp32 scales, the reference's shapes and
  dtypes, under 0.6x the fp cache's bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro_torch.launch import generate
from repro_torch.models import blocks as tblocks
from repro_torch.models import build, get_config
from repro_torch.models.convert import params_from_numpy

LOGIT_TOL = 1e-5
SCALE_RTOL = 1e-5
BOUNDARY = 1e-3           # |frac(t / scale) - 0.5| within which a value
                          # may round either way
ARCHS = ("qwen2_72b", "h2o_danube_1_8b")
DECODE_STEPS = 3


def _rows():
    rng = np.random.default_rng(0)
    out = {f"random x{m}": (rng.standard_normal((3, 4, 7, 32)) * m
                            ).astype(np.float32) for m in (1e-3, 1.0, 50.0)}
    out["zero"] = np.zeros((2, 5, 8), np.float32)
    # amax 127 makes the scale exactly 1: these quotients are exact halves
    half = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                    np.float32)
    out["halves"] = np.stack([half, -half, half * 0])
    return out


@pytest.mark.parametrize("name", sorted(_rows()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_bit_equal_to_reference(name, dtype):
    x = _rows()[name]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jblocks.quantize_kv(jx)
    tq, ts = tblocks.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    for out in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jblocks.dequantize_kv(jq, js, out), np.float32)
        got = tblocks.dequantize_kv(tq, ts, getattr(torch, out.__name__))
        assert np.array_equal(got.float().numpy(), want)
    if name == "zero":
        assert not tq.any() and float(tblocks.dequantize_kv(
            tq, ts, torch.float32).abs().sum()) == 0


def _models(arch, quant="int8"):
    jcfg = jget_config(arch, reduced=True).with_(dtype="float32")
    tcfg = get_config(arch, reduced=True).with_(dtype="float32")
    jm = jbuild(jcfg.with_(kv_cache_dtype=quant))
    tm = build(tcfg.with_(kv_cache_dtype=quant))
    params = jm.init(jax.random.key(3))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    return jm, tm, params


def _check_int8(got_q, got_s, want_q, want_s, fp, note):
    """The port's int8 values and scales against the reference's; ``fp``
    is the reference's unquantized tensor, whose quotients say which
    values lie at a rounding boundary.  Returns the entries that
    differ."""
    np.testing.assert_allclose(got_s, want_s, rtol=SCALE_RTOL, atol=0,
                               err_msg=note)
    quot = fp / want_s[..., None]
    at_edge = np.abs(np.abs(quot - np.trunc(quot)) - 0.5) <= BOUNDARY
    diff = got_q.astype(np.int32) - want_q.astype(np.int32)
    assert (diff[~at_edge] == 0).all(), note
    assert (np.abs(diff) <= 1).all(), note
    n = int((diff != 0).sum())
    if n:
        print(f"{note}: {n} of {diff.size} int8 values one step apart, "
              f"each at a rounding boundary")
    return n


_RUNS: dict = {}


def _run(arch):
    """Prefill 80 tokens (past h2o's reduced window of 64) with headroom,
    then DECODE_STEPS steps: each package's int8 path, the reference's
    fp path, and the port's decode on the reference's int8 cache."""
    if arch in _RUNS:
        return _RUNS[arch]
    jm, tm, params = _models(arch)
    jfp = jbuild(jm.cfg.with_(kv_cache_dtype="model"))
    S = 80
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab,
                                             (2, S)).astype(np.int32)
    cache_len = S + DECODE_STEPS
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                        cache_len=cache_len)
    _, jfc = jfp.prefill(params, {"tokens": jnp.asarray(toks)},
                         cache_len=cache_len)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks)},
                        cache_len=cache_len)
    tm_fp = build(tm.cfg.with_(kv_cache_dtype="model"))
    tm_fp.params = tm.params
    _, tfc = tm_fp.prefill({"tokens": torch.from_numpy(toks)},
                           cache_len=cache_len)
    out = {"S": S, "jl": np.asarray(jl), "tl": tl.numpy(),
           "jc": jax.tree.map(np.asarray, jc),
           "jfc": jax.tree.map(np.asarray, jfc),
           "tc": {k: v.clone().numpy() for k, v in tc.items()},
           "tfc": {k: v.numpy() for k, v in tfc.items()}, "steps": []}
    jstep = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    quantize = tblocks.quantize_kv
    for i in range(DECODE_STEPS):
        before = jax.tree.map(np.asarray, jc)
        mine = {k: torch.from_numpy(v.copy()) for k, v in before.items()}
        jl, jc = jstep(params, jc, jnp.asarray(tok),
                       jnp.asarray(S + i, jnp.int32))
        # the new slot's unquantized k and v, as the port's decode hands
        # them to quantize_kv (layer by layer, k then v)
        seen = []
        tblocks.quantize_kv = lambda t: (seen.append(t.numpy().copy()),
                                         quantize(t))[1]
        try:
            tl, mine = tm.decode_step(mine, torch.from_numpy(tok), S + i)
        finally:
            tblocks.quantize_kv = quantize
        out["steps"].append({
            "pos": S + i, "jl": np.asarray(jl), "tl": tl.numpy(),
            "before": before, "jc": jax.tree.map(np.asarray, jc),
            "fp": {"k": np.stack(seen[0::2]), "v": np.stack(seen[1::2])},
            "tc": {k: v.numpy() for k, v in mine.items()}})
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _RUNS[arch] = out
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_matches_reference(arch):
    r = _run(arch)
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    tc, jc = r["tc"], r["jc"]
    assert tc["k"].dtype == np.int8 and tc["k_scale"].dtype == np.float32
    assert {k: v.shape for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    for name in ("k", "v"):
        own_q, own_s = tblocks.quantize_kv(torch.from_numpy(r["tfc"][name]))
        assert np.array_equal(tc[name], own_q.numpy())
        assert np.array_equal(tc[f"{name}_scale"], own_s.numpy())
        _check_int8(tc[name], tc[f"{name}_scale"], jc[name],
                    jc[f"{name}_scale"], r["jfc"][name], f"{arch} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_matches_reference_on_its_cache(arch):
    r = _run(arch)
    for st in r["steps"]:
        np.testing.assert_allclose(st["tl"], st["jl"], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=str(st["pos"]))
        assert np.array_equal(st["tl"].argmax(-1), st["jl"].argmax(-1))
        Sc = st["before"]["k"].shape[3]
        slot = st["pos"] % Sc
        for name in ("k", "v"):
            for part in (name, f"{name}_scale"):
                got, was = st["tc"][part], st["before"][part]
                others = np.ones(Sc, bool)
                others[slot] = False
                assert np.array_equal(got[:, :, :, others],
                                      was[:, :, :, others]), part
            _check_int8(st["tc"][name][:, :, :, slot],
                        st["tc"][f"{name}_scale"][:, :, :, slot],
                        st["jc"][name][:, :, :, slot],
                        st["jc"][f"{name}_scale"][:, :, :, slot],
                        st["fp"][name],
                        f"{arch} {name} pos {st['pos']}")


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_close_to_fp(arch):
    """The reference's own contract, on the port alone: prefill + decode
    with the int8 cache tracks the fp cache within quantization noise
    and predicts the same top-1 (tests/test_int8_kv_cache.py's shapes)."""
    _, tm, _ = _models(arch)
    tm_fp = build(tm.cfg.with_(kv_cache_dtype="model"))
    tm_fp.params = tm.params
    B, S = 2, 48
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab,
                                         (B, S - 1)).astype(np.int32))
    tok = torch.from_numpy(rng.integers(0, tm.cfg.vocab,
                                        (B, 1)).astype(np.int32))
    _, cache_fp = tm_fp.prefill({"tokens": toks}, cache_len=S)
    logits_fp, _ = tm_fp.decode_step(cache_fp, tok, S - 1)
    _, cache_q8 = tm.prefill({"tokens": toks}, cache_len=S)
    assert cache_q8["k"].dtype == torch.int8 and "k_scale" in cache_q8
    logits_q8, cache_q8 = tm.decode_step(cache_q8, tok, S - 1)
    assert cache_q8["k"].dtype == torch.int8
    lf, lq = logits_fp.numpy(), logits_q8.numpy()
    np.testing.assert_allclose(lq, lf, rtol=0.1, atol=0.15)
    np.testing.assert_array_equal(lq.argmax(-1), lf.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_spec_matches_reference_and_is_under_0_6x(arch):
    cfg = get_config(arch).with_(kv_groups=16)
    jcfg = jget_config(arch).with_(kv_groups=16)
    size = lambda spec: sum(t.numel() * t.element_size()
                            for t in spec.values())
    fp = build(cfg).cache_spec(128, 32768)
    q8 = build(cfg.with_(kv_cache_dtype="int8")).cache_spec(128, 32768)
    assert size(q8) < 0.6 * size(fp)
    want = jbuild(jcfg.with_(kv_cache_dtype="int8")).cache_spec(128, 32768)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in q8.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_generate_with_the_int8_cache_on_cpu():
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "70", "--steps", "4", "--seed", "3"]
    fp = generate.main(args)
    q8 = generate.main(args + ["--kv-cache-dtype", "int8"])
    assert q8["kv_cache_dtype"] == "int8" and fp["kv_cache_dtype"] == "model"
    assert q8["cache_bytes"] < 0.6 * fp["cache_bytes"]
    ids = np.asarray(q8["ids"])
    assert ids.shape == (2, 5) and ((ids >= 0) & (ids < get_config(
        "h2o-danube-1.8b", True).padded_vocab)).all()


@pytest.mark.cuda
def test_int8_decode_on_card_matches_cpu():
    """Reduced h2o-danube with the int8 cache on the card, fp32: decode
    on the CPU's own int8 cache gives logits within 1e-5 of the CPU's,
    and the new slot quantized as the CPU quantizes it but for values at
    a rounding boundary; skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, tm, params = _models("h2o_danube_1_8b")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.cfg.vocab, (2, 80)).astype(np.int32))
    _, cache = tm.prefill({"tokens": toks})
    on_card = build(tm.cfg)
    params_from_numpy(on_card, jax.tree.map(np.asarray, params), "cuda")
    card_cache = {k: v.cuda() for k, v in cache.items()}
    want, cache = tm.decode_step(cache, toks[:, -1:], 80)
    got, card_cache = on_card.decode_step(card_cache, toks[:, -1:].cuda(),
                                          80)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(card_cache[name].cpu().numpy(),
                                   cache[name].numpy(), rtol=SCALE_RTOL,
                                   atol=0)
    for name in ("k", "v"):
        diff = card_cache[name].cpu().int() - cache[name].int()
        assert int(diff.abs().max()) <= 1
