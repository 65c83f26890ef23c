"""The port's Mamba block, selective scan and ``MambaLM`` against the JAX
package's.

fp32 throughout.  The reference's params, drawn from its key, are carried
into the port (as tensors, or by ``models.convert.params_from_numpy``),
and the same inputs, made by numpy from a seed, go through both.

- The plain scan (``kernels.ref.selective_scan``, step by step) against
  the reference's ``_selective_scan_chunk`` (a log-depth associative
  scan): h_last and y within 1e-5 (fp32 products in another order); the
  plain fused tail (``kernels.ref.selective_scan_fused``: softplus, the
  chunked scan, the D skip, the gate) against the reference's own tail of
  ``mamba_apply``, within 1e-5.
- ``mamba_apply``, ``mamba_prefill`` (h and conv state) and
  ``mamba_decode`` against the reference's, within 1e-5; S past one
  256-step chunk and not a multiple of it, and S < d_conv - 1 (the conv
  state left-padded).
- The contracts of ``tests/test_recurrent_blocks.py`` on the port: the
  chunked scan against the stepwise decode (2e-4), ``mamba_apply`` equal
  to ``mamba_prefill``'s output (1e-5), chunk-size invariance (1e-5).
- Reduced falcon-mamba-7b as ``MambaLM``: prefill and decode logits
  within 2e-4, the loss within 1e-5 relative, every gradient leaf within
  2e-4 * max|g_ref| of its leaf (``tests/test_torch_lm_train.py``'s
  tolerances), the caches within 1e-5.
- The ``cuda`` test at the end holds the kernel to the plain version on
  the card; it skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss
from repro_torch.models import build, get_config, get_model
from repro_torch.models import blocks as tblocks
from repro_torch.models.config import ArchConfig, SSMConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import ParamTree
from repro_torch.models.ssm import MambaLM

SCAN_TOL = 1e-5
BLOCK_TOL = 1e-5
CONTRACT_TOL = 2e-4       # tests/test_recurrent_blocks.py's
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
ARCH = "falcon_mamba_7b"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(d=32, st=4):
    kw = dict(arch_id="ssm-t", family="ssm", n_layers=1, d_model=d,
              n_heads=0, n_kv_heads=1, d_ff=0, vocab=64, dtype="float32",
              attention="none")
    return (JArchConfig(ssm=JSSMConfig(d_state=st, d_conv=4, expand=2), **kw),
            ArchConfig(ssm=SSMConfig(d_state=st, d_conv=4, expand=2), **kw))


def _params(jcfg, seed=0):
    """The reference's ``mamba_init`` params, as jnp and as a ParamTree."""
    p = jblocks.mamba_init(jax.random.key(seed), jcfg)
    return p, ParamTree(jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                                     p))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _scan_inputs(B, c, d_in, st, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    dt = np.log1p(np.exp(f(B, c, d_in)))                      # softplus
    A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (d_in, 1)) \
        * np.exp(0.1 * f(d_in, st))
    return f(B, d_in, st), dt, f(B, c, st), f(B, c, st), A, f(B, c, d_in)


# ------------------------------ the scan ------------------------------ #
@pytest.mark.parametrize("B,c,d_in,st", [(2, 24, 64, 4), (1, 256, 64, 4),
                                         (2, 33, 512, 8), (1, 1, 32, 16),
                                         (2, 40, 128, 16)])
def test_plain_scan_matches_reference_chunk(B, c, d_in, st):
    args = _scan_inputs(B, c, d_in, st, seed=B + c + st)
    jh, jy = jblocks._selective_scan_chunk(*map(jnp.asarray, args))
    th, ty = tref.selective_scan(*map(torch.from_numpy, args))
    assert th.dtype == ty.dtype == torch.float32
    assert tuple(ty.shape) == (B, c, d_in) and tuple(th.shape) == (B, d_in,
                                                                   st)
    _close(th, jh, SCAN_TOL)
    _close(ty, jy, SCAN_TOL)


def test_scan_wrapper_runs_the_plain_version_on_cpu_with_a_gradient():
    """On CPU tensors the wrapper is the plain version, gradient and all,
    and launches nothing."""
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 16, 32, 8, 3)]
    args[1].requires_grad_(True)
    tss.reset_launches()
    h, y = tss.selective_scan(*args)
    (h.sum() + y.sum()).backward()
    assert args[1].grad is not None and torch.isfinite(args[1].grad).all()
    assert tss.launches == {"selective_scan_forward": 0,
                            "selective_scan_fused": 0,
                            "selective_scan_fused_backward": 0}
    h2, y2 = tref.selective_scan(*args)
    assert torch.equal(h, h2) and torch.equal(y, y2)


@pytest.mark.parametrize("bad", ["dt rank", "Bm", "A", "h0"])
def test_scan_wrapper_rejects_shapes_that_do_not_fit(bad):
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 8, 16, 4, 4)]
    idx, val = {"dt rank": (1, args[1][0]), "Bm": (2, args[2][..., :3]),
                "A": (4, args[4].T.contiguous()),
                "h0": (0, args[0][:1])}[bad]
    args[idx] = val
    with pytest.raises(ValueError):
        tss.selective_scan(*args)


def _reference_tail(h0, dt, Bm, Cm, A, xc, D, z, chunk=256):
    """The reference's tail of ``mamba_apply`` (``repro.models.blocks``,
    lines 642-659) from a state h0: softplus of dt in fp32, the scan over
    zero-padded chunks under ``lax.scan`` with ``_selective_scan_chunk``,
    the D skip, the silu(z) gate, cast to xc's dtype."""
    dt = jax.nn.softplus(dt.astype(jnp.float32))
    B, S, d_in = xc.shape
    c = min(chunk, S)
    pad = -S % c
    padded = [jnp.pad(a, ((0, 0), (0, pad), (0, 0)))
              for a in (dt, Bm, Cm, xc)]
    n = padded[0].shape[1] // c
    reshape = lambda a: jnp.moveaxis(a.reshape(B, n, c, -1), 1, 0)

    def step(h, inp):
        dt_i, B_i, C_i, x_i = inp
        return jblocks._selective_scan_chunk(h, dt_i, B_i, C_i, A, x_i)

    h, ys = jax.lax.scan(step, h0, tuple(map(reshape, padded)))
    y = jnp.moveaxis(ys, 0, 1).reshape(B, n * c, d_in)[:, :S]
    y = y + D * xc.astype(jnp.float32)
    return h, (y * jax.nn.silu(z.astype(jnp.float32))).astype(xc.dtype)


@pytest.mark.parametrize("st", [4, 8])
@pytest.mark.parametrize("S", [24, 300, 1])
@pytest.mark.parametrize("h0_zero", [True, False])
def test_plain_fused_matches_the_references_tail(st, S, h0_zero):
    """``ref.selective_scan_fused`` against the reference's own tail of
    ``mamba_apply`` on the same numpy inputs, z a strided half of one
    (B, S, 2 d_in) tensor, dt_proj's bias added apart (the reference's
    ``dense`` adds it before the tail), in fp32: h_last and out within
    1e-5."""
    B, d_in = 2, 64
    rng = np.random.default_rng(S * 10 + st + h0_zero)
    f = lambda *sh: rng.standard_normal(sh, dtype=np.float32)
    h0 = np.zeros((B, d_in, st), np.float32) if h0_zero else f(B, d_in, st)
    dt, xc, D = f(B, S, d_in) * 2, f(B, S, d_in), f(d_in)
    bc, xz = f(B, S, 2 * st), f(B, S, 2 * d_in)
    A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (d_in, 1)) \
        * np.exp(0.1 * f(d_in, st))
    bias = f(d_in) * 0.5
    jh, jout = _reference_tail(
        jnp.asarray(h0), jnp.asarray(dt + bias), jnp.asarray(bc[..., :st]),
        jnp.asarray(bc[..., st:]), jnp.asarray(A), jnp.asarray(xc),
        jnp.asarray(D), jnp.asarray(xz[..., d_in:]))
    t = torch.from_numpy
    tbc, txz = t(bc), t(xz)
    z = txz[..., d_in:]
    assert z.stride(1) == 2 * d_in                    # a strided view
    th, tout = tref.selective_scan_fused(
        None if h0_zero else t(h0), t(dt), tbc[..., :st], tbc[..., st:],
        t(A), t(xc), t(D), z, t(bias))
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (B, S, d_in)
    _close(th, jh, SCAN_TOL)
    _close(tout, jout, SCAN_TOL)


def test_kernel_state_sizes_are_the_zoos():
    """The kernel is built for the reference's test d_state (4), reduced
    falcon-mamba's (8) and falcon-mamba-7b's (16)."""
    assert get_config(ARCH).ssm.d_state in tss.D_STATES
    assert get_config(ARCH, True).ssm.d_state in tss.D_STATES
    assert _cfgs()[1].ssm.d_state in tss.D_STATES


# ------------------------------ the block ----------------------------- #
@pytest.mark.parametrize("S,chunk", [(24, 256), (300, 256), (40, 8),
                                     (33, 16)])
def test_mamba_apply_matches_reference(S, chunk):
    jcfg, tcfg = _cfgs()
    p, tp = _params(jcfg)
    x = _x((2, S, jcfg.d_model), seed=S)
    want = jblocks.mamba_apply(p, jnp.asarray(x), jcfg, chunk=chunk)
    got = tblocks.mamba_apply(tp, torch.from_numpy(x), tcfg, chunk=chunk)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("S", [2, 24, 300])
def test_mamba_prefill_matches_reference(S):
    """y, the scan state and the conv state (left-padded when S < cw - 1)."""
    jcfg, tcfg = _cfgs(st=8)
    p, tp = _params(jcfg, seed=2)
    x = _x((2, S, jcfg.d_model), seed=S + 1)
    jy, jh, jc = jblocks.mamba_prefill(p, jnp.asarray(x), jcfg)
    ty, th, tc = tblocks.mamba_prefill(tp, torch.from_numpy(x), tcfg)
    assert tuple(tc.shape) == (2, 3, 2 * jcfg.d_model)
    _close(ty, jy, BLOCK_TOL)
    _close(th, jh, BLOCK_TOL)
    _close(tc, jc, BLOCK_TOL)


def test_mamba_decode_matches_reference():
    jcfg, tcfg = _cfgs(st=8)
    p, tp = _params(jcfg, seed=3)
    d_in = 2 * jcfg.d_model
    x = _x((2, 1, jcfg.d_model), seed=4)
    h = _x((2, d_in, 8), seed=5)
    conv = _x((2, 3, d_in), seed=6)
    jy, jh, jc = jblocks.mamba_decode(p, jnp.asarray(x), jnp.asarray(h),
                                      jnp.asarray(conv), jcfg)
    ty, th, tc = tblocks.mamba_decode(tp, torch.from_numpy(x),
                                      torch.from_numpy(h),
                                      torch.from_numpy(conv), tcfg)
    _close(ty, jy, BLOCK_TOL)
    _close(th, jh, BLOCK_TOL)
    _close(tc, jc, BLOCK_TOL)


def test_mamba_init_matches_the_references_shapes_and_dtypes():
    """Every leaf's shape, and its dtype in a bf16 model: A_log and D stay
    fp32 leaves; A_log is log(1 .. d_state) per channel (to an ulp: two
    libraries' logs), D ones."""
    jcfg = jget_config(ARCH, True)
    tcfg = get_config(ARCH, True)
    jp = jblocks.mamba_init(jax.random.key(0), jcfg)
    tp = tblocks.mamba_init(torch.Generator().manual_seed(0), tcfg)
    flat = lambda t: {".".join(str(k.key) for k in path): v for path, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    jf, tf = flat(jp), flat(tp)
    assert set(jf) == set(tf)
    for name in jf:
        assert tuple(tf[name].shape) == jf[name].shape, name
        want = torch.float32 if name in ("A_log", "D") else torch.bfloat16
        assert tf[name].dtype == want, name
    _close(tf["A_log"], jf["A_log"], 1e-6)
    _close(tf["D"], jf["D"], 0)


# --------------- tests/test_recurrent_blocks.py, on the port ------------ #
def test_port_chunked_scan_matches_stepwise_decode():
    """Prefill over S steps == decoding the same S tokens one at a time."""
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    B, S = 2, 24
    x = torch.from_numpy(_x((B, S, cfg.d_model), seed=7))
    y_full, h_full, conv_full = tblocks.mamba_prefill(p, x, cfg)
    d_in = cfg.ssm.expand * cfg.d_model
    h = torch.zeros((B, d_in, cfg.ssm.d_state))
    conv = torch.zeros((B, cfg.ssm.d_conv - 1, d_in))
    ys = []
    for t in range(S):
        y, h, conv = tblocks.mamba_decode(p, x[:, t:t + 1], h, conv, cfg)
        ys.append(y)
    _close(torch.cat(ys, dim=1), y_full, CONTRACT_TOL)
    _close(h, h_full, CONTRACT_TOL)
    _close(conv, conv_full, 1e-5)


def test_port_mamba_apply_equals_prefill_output():
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(_x((1, 40, cfg.d_model), seed=8))
    y1 = tblocks.mamba_apply(p, x, cfg, chunk=8)
    y2, _, _ = tblocks.mamba_prefill(p, x, cfg)
    _close(y1, y2, 1e-5)


def test_port_mamba_chunk_size_invariance():
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(_x((1, 33, cfg.d_model), seed=9))
    y8 = tblocks.mamba_apply(p, x, cfg, chunk=8)
    for chunk in (16, 64):
        _close(tblocks.mamba_apply(p, x, cfg, chunk=chunk), y8, 1e-5)


# ------------------------------ MambaLM ------------------------------- #
def test_zoo_builds_falcon_mamba():
    for reduced in (False, True):
        cfg, model = get_model("falcon-mamba-7b", reduced=reduced)
        assert isinstance(model, MambaLM) and cfg.family == "ssm"
        assert model.supports_long_context()
    cfg = get_config(ARCH)
    assert 7.2e9 < cfg.n_params() < 7.3e9
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.d_state) == (64, 4096, 16)


_LM: dict = {}


def _lm():
    """Both packages' reduced model on the same params and tokens: prefill
    logits and caches, two decode steps' logits, the loss and its
    gradients."""
    if _LM:
        return _LM
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.key(11))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(12)
    B, S = 2, 40
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.1] = -1
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks)})
    caches = {k: (np.asarray(jc[k]), tc[k].clone().numpy()) for k in jc}
    steps = []
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(2):
        jd, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(S + i, jnp.int32))
        td, tc = tm.decode_step(tc, torch.from_numpy(tok), S + i)
        steps.append((np.asarray(jd), td.numpy()))
        tok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    batch = {"tokens": toks, "labels": labels}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    tm._p().requires_grad_(True)
    tloss, _ = tm.loss(jax.tree.map(torch.from_numpy, batch))
    tloss.backward()
    _LM.update({
        "prefill": (np.asarray(jl), tl.numpy()), "steps": steps,
        "caches": caches,
        "decoded_cache": {k: (np.asarray(jc[k]), tc[k].numpy())
                          for k in jc},
        "loss": (float(jloss), float(tloss.detach())),
        "jgrads": jax.tree.map(np.asarray, jg),
        "tgrads": {n: t.grad.numpy()
                   for n, t in tm.params.named_parameters()}})
    return _LM


def test_mambalm_prefill_logits_and_state_match_reference():
    r = _lm()
    want, got = r["prefill"]
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    for name, (jc, tc) in r["caches"].items():
        assert tc.shape == jc.shape, name
        _close(tc, jc, BLOCK_TOL)


def test_mambalm_decode_matches_reference_and_updates_state_in_place():
    r = _lm()
    for i, (want, got) in enumerate(r["steps"]):
        _close(got, want, LOGIT_TOL)
        assert np.array_equal(got.argmax(-1), want.argmax(-1)), i
    for name, (jc, tc) in r["decoded_cache"].items():
        _close(tc, jc, BLOCK_TOL)


def test_mambalm_loss_matches_reference():
    want, got = _lm()["loss"]
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_mambalm_every_gradient_leaf_matches_reference():
    """Each stacked reference leaf ``(L, ...)`` against the port's per-layer
    leaves ``layers.i.<path>``; every leaf has a gradient."""
    r = _lm()
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


def test_mambalm_cache_is_constant_size_and_matches_the_spec():
    model = build(get_config(ARCH, True))
    small, big = model.cache_spec(2, 1_000), model.cache_spec(2, 1_000_000)
    assert {k: tuple(v.shape) for k, v in small.items()} == \
        {k: tuple(v.shape) for k, v in big.items()}
    assert small["h"].dtype == torch.float32
    assert small["conv"].dtype == torch.bfloat16
    r = _lm()
    fp32 = build(get_config(ARCH, True).with_(dtype="float32"))
    spec = fp32.cache_spec(2, 40)
    for name, (_, tc) in r["caches"].items():
        assert tc.shape == tuple(spec[name].shape), name


def test_launch_generate_reports_the_state_bytes():
    from repro_torch.launch import generate
    out = generate.main(["--arch", "falcon-mamba-7b", "--reduced",
                         "--device", "cpu", "--prompt-len", "20",
                         "--steps", "3"])
    cfg = get_config(ARCH, True)
    d_in = cfg.ssm.expand * cfg.d_model
    assert out["state_bytes"] == out["cache_bytes"] == cfg.n_layers * 2 * (
        d_in * cfg.ssm.d_state * 4 + (cfg.ssm.d_conv - 1) * d_in * 2)
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 4) and ((ids >= 0) & (ids < cfg.padded_vocab)).all()
    assert out["scan_launches_prefill"] == 0         # the plain path here


# ------------------------------- the card ----------------------------- #
@pytest.mark.cuda
def test_scan_kernel_matches_plain_on_card():
    """The kernel against the plain version on the card at the reduced
    shapes, fp32 and bf16 inputs, y and h_last within 2e-4 (the
    reference's chunked-against-stepwise tolerance), one launch a call; a
    gradient asked on the card raises.  Skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tss.reset_launches()
    n = 0
    for B, c, d_in, st in ((2, 24, 64, 4), (2, 300, 512, 8), (1, 1, 32, 16),
                           (2, 257, 1024, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(a).cuda()
                    for a in _scan_inputs(B, c, d_in, st, seed=c)]
            for i in (2, 3, 5):
                args[i] = args[i].to(dtype)
            h, y = tss.selective_scan(*args)
            hp, yp = tref.selective_scan(*args)
            torch.cuda.synchronize()
            n += 1
            _close(h.cpu(), hp.cpu(), 2e-4)
            _close(y.cpu(), yp.cpu(), 2e-4)
    assert tss.launches == {"selective_scan_forward": n,
                            "selective_scan_fused": 0,
                            "selective_scan_fused_backward": 0}
    args[1].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tss.selective_scan(*args)
