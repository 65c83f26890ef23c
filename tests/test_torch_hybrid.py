"""The port's RG-LRU block, ``HybridLM`` (recurrentgemma) and the SWA
attention at head dim 256 against the JAX package's.

fp32 throughout.  The reference's params, drawn from its key, are carried
into the port (as tensors, or by ``models.convert.params_from_numpy``),
and the same inputs, made by numpy from a seed, go through both.

- ``_rglru_scan`` (a log-depth scan within 256-step chunks, a carry across
  them) against the reference's (an associative scan under ``lax.scan``):
  y and h_last within 1e-5; ``rglru_apply`` with and without h0 and the
  conv state, and ``rglru_decode``, within 1e-5.  At a ragged last chunk
  past 256 steps the reference's h_last is its zero padding's (0): the
  port's is the state after the last real step, which its stepwise decode
  reaches (ROADMAP Queue 3 item 5).
- The contracts of ``tests/test_recurrent_blocks.py`` on the port: prefill
  equals the stepwise decode (2e-4), the state decays.
- Reduced recurrentgemma-2b as ``HybridLM``, its params carried by
  ``params_from_numpy`` (period i's ``l{j}`` is layer 3 i + j, ``rem{r}``
  layer 3 P + r): prefill and decode logits within 2e-4, the caches within
  1e-5, the loss within 1e-5 relative, every gradient leaf within 2e-4 *
  max|g_ref| of its leaf; ``launch.train``'s first loss against the
  reference trainer's, ``launch.generate``'s cache bytes.
- The plain SWA backward at d = 256 (recurrentgemma's head dim) against
  ``jax.vjp`` of the reference's plain attention and of its zoo scan.
- The ``cuda`` tests at the end hold the d = 256 kernels to their plain
  versions on the card; they skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import HybridConfig as JHybridConfig
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_attention as tswa
from repro_torch.launch import generate as tgenerate
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import build, get_config
from repro_torch.models import blocks as tblocks
from repro_torch.models.config import ArchConfig, HybridConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.layers import ParamTree
from repro_torch.models.lm import cache_leaves

BLOCK_TOL = 1e-5
CONTRACT_TOL = 2e-4       # tests/test_recurrent_blocks.py's
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
PALLAS_TOL = 2e-4         # the reference's SWA tolerance (test_kernels.py)
ARCH = "recurrentgemma_2b"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(d=32):
    """tests/test_recurrent_blocks.py's hybrid config, in both packages."""
    kw = dict(arch_id="hyb-t", family="hybrid", n_layers=3, d_model=d,
              n_heads=2, n_kv_heads=1, d_ff=64, vocab=64, dtype="float32",
              act="gelu")
    return (JArchConfig(hybrid=JHybridConfig(lru_width=d, conv_width=4,
                                             window=8), **kw),
            ArchConfig(hybrid=HybridConfig(lru_width=d, conv_width=4,
                                           window=8), **kw))


def _params(jcfg, seed=0):
    """The reference's ``rglru_init`` params, as jnp and as a ParamTree."""
    p = jblocks.rglru_init(jax.random.key(seed), jcfg)
    return p, ParamTree(jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                                     p))


def _x(shape, seed=1, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


# ------------------------------ RG-LRU -------------------------------- #
@pytest.mark.parametrize("S", [1, 20, 256, 512, 300])
def test_rglru_scan_matches_reference(S):
    """y within 1e-5 at every length; h_last too, except past one chunk at
    a ragged length (S 300), where the reference's is 0 and the port's is
    y's last row, the state after the last step."""
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    xc = _x((2, S, 32), seed=S)
    h0 = _x((2, 32), seed=S + 1)
    jy, jh = jblocks._rglru_scan(jp, jnp.asarray(xc), jnp.asarray(h0))
    ty, th = tblocks._rglru_scan(tp, torch.from_numpy(xc),
                                 torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy, BLOCK_TOL)
    _close(th, ty[:, -1], 0.0)
    if S > 256 and S % 256:
        assert not np.asarray(jh).any()          # the reference's padding
    else:
        _close(th, jh, BLOCK_TOL)


def test_linear_scan_is_the_step_by_step_recurrence():
    """The doubling scan of (a, b) pairs equals h_t = a_t h_{t-1} + b_t
    from 0, and its first output is the running product of a."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    prod, h = tblocks._linear_scan(a, b)
    want_h, want_p = torch.zeros(2, 5, dtype=a.dtype), torch.ones(2, 5,
                                                                  dtype=a.dtype)
    for t in range(37):
        want_h = a[:, t] * want_h + b[:, t]
        want_p = want_p * a[:, t]
        torch.testing.assert_close(h[:, t], want_h)
        torch.testing.assert_close(prod[:, t], want_p)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [2, 20, 300])
def test_rglru_apply_matches_reference(S, with_state):
    """Output, h_last and the conv tail within 1e-5, from zeros or from h0
    and a conv state; S < conv_width - 1 left-pads the tail."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, S, 32), seed=S + 7)
    kw_j, kw_t = {}, {}
    if with_state:
        h0, cs = _x((2, 32), seed=5), _x((2, 3, 32), seed=6)
        kw_j = dict(h0=jnp.asarray(h0), conv_state=jnp.asarray(cs))
        kw_t = dict(h0=torch.from_numpy(h0), conv_state=torch.from_numpy(cs))
    jy, jh, jc = jblocks.rglru_apply(jp, jnp.asarray(x), jcfg,
                                     return_state=True, **kw_j)
    ty, th, tc = tblocks.rglru_apply(tp, torch.from_numpy(x), tcfg,
                                     return_state=True, **kw_t)
    _close(ty, jy, BLOCK_TOL)
    _close(tc, jc, BLOCK_TOL)
    if not (S > 256 and S % 256):
        _close(th, jh, BLOCK_TOL)
    _close(tblocks.rglru_apply(tp, torch.from_numpy(x), tcfg, **kw_t),
           jy, BLOCK_TOL)


def test_rglru_decode_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x, h, cs = _x((2, 1, 32), 2), _x((2, 32), 3), _x((2, 3, 32), 4)
    jy, jh, jc = jblocks.rglru_decode(jp, jnp.asarray(x), jnp.asarray(h),
                                      jnp.asarray(cs), jcfg)
    ty, th, tc = tblocks.rglru_decode(tp, torch.from_numpy(x),
                                      torch.from_numpy(h),
                                      torch.from_numpy(cs), tcfg)
    for got, want in ((ty, jy), (th, jh), (tc, jc)):
        assert tuple(got.shape) == want.shape
        _close(got, want, BLOCK_TOL)


def test_rglru_init_matches_the_references_shapes_and_dtypes():
    jcfg = jget_config(ARCH)
    want = jblocks.rglru_init(jax.random.key(0), jcfg)
    got = tblocks.rglru_init(None, get_config(ARCH))
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat) == 10
    for path, leaf in flat.items():
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path


def test_port_rglru_prefill_matches_stepwise_decode():
    """tests/test_recurrent_blocks.py's contract on the port (2e-4), and
    at S 300: past one chunk and ragged, where the port's prefill state is
    the one decode reaches."""
    _, tcfg = _cfgs()
    for S in (20, 300):
        _, tp = _params(_cfgs()[0])
        x = torch.from_numpy(_x((2, S, 32), seed=S))
        y_full, h_full, _ = tblocks.rglru_apply(tp, x, tcfg,
                                                return_state=True)
        h = torch.zeros(2, 32)
        conv = torch.zeros(2, 3, 32)
        ys = []
        for t in range(S):
            y, h, conv = tblocks.rglru_decode(tp, x[:, t:t + 1], h, conv,
                                              tcfg)
            ys.append(y)
        _close(torch.cat(ys, 1), y_full, CONTRACT_TOL)
        _close(h, h_full, CONTRACT_TOL)


def test_port_rglru_state_decays():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    h0 = 100.0 * torch.ones(1, 32)
    _, h_end = tblocks._rglru_scan(tp, torch.zeros(1, 50, 32), h0)
    assert float(h_end.abs().max()) < float(h0.abs().max())


def test_rglru_scan_has_a_gradient():
    """Autograd through the chunked scan equals autograd through the
    stepwise recurrence (fp64), across a chunk boundary."""
    jp, _ = _params(_cfgs()[0])
    p = ParamTree(jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float64), jp))
    xc = torch.from_numpy(_x((1, 20, 32), 9)).double().requires_grad_(True)
    h0 = torch.zeros(1, 32, dtype=torch.float64)
    y, _ = tblocks._rglru_scan(p, xc, h0, chunk=8)
    g_scan, = torch.autograd.grad(y.sum(), xc)
    a, gated = tblocks._rglru_gates(p, xc)
    h, ys = h0, []
    for t in range(20):
        h = a[:, t] * h + gated[:, t]
        ys.append(h)
    g_step, = torch.autograd.grad(torch.stack(ys, 1).sum(), xc)
    torch.testing.assert_close(g_scan, g_step)


# ------------------------------ the model ----------------------------- #
_LM: dict = {}


def _port_grad_names(path, ref):
    """The port's names of a reference gradient leaf: period i's ``l{j}``
    leaf (stacked) is layer 3 i + j's, ``rem{r}`` layer 3 P + r's."""
    keys = [k.key for k in path]
    if keys[0] != "layers":
        return [(".".join(keys), ref)]
    if keys[1] == "periods":
        j = int(keys[2][1:])
        return [(f"layers.{3 * i + j}.{'.'.join(keys[3:])}", ref[i])
                for i in range(ref.shape[0])]
    n_periods = _LM["n_periods"]
    r = int(keys[1][3:])
    return [(f"layers.{3 * n_periods + r}.{'.'.join(keys[2:])}", ref)]


def _lm():
    """Both packages' reduced model on the same params and tokens: prefill
    logits and caches, two decode steps' logits and caches, the loss and
    its gradients.  S 80 wraps the 64-key window, as the reference's
    consistency test runs the hybrid."""
    if _LM:
        return _LM
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).with_(dtype="float32")
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.key(21))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(22)
    B, S = 2, 80
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.1] = -1
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks)})
    caches = [(np.asarray(a), b.clone().numpy())
              for a, b in zip(jax.tree.leaves(jc), cache_leaves(tc))]
    steps = []
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(2):
        jd, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(S + i, jnp.int32))
        td, tc = tm.decode_step(tc, torch.from_numpy(tok.copy()), S + i)
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
        "n_periods": tm.n_periods,
        "prefill": (np.asarray(jl), tl.numpy()), "steps": steps,
        "caches": caches,
        "decoded_cache": [(np.asarray(a), b.numpy()) for a, b in
                          zip(jax.tree.leaves(jc), cache_leaves(tc))],
        "loss": (float(jloss), float(tloss.detach())),
        "jgrads": jax.tree.map(np.asarray, jg),
        "tgrads": {n: t.grad.numpy()
                   for n, t in tm.params.named_parameters()}})
    return _LM


def test_hybrid_layers_follow_the_pattern():
    cfg = get_config(ARCH)
    model = build(cfg)
    assert isinstance(model, HybridLM)
    assert (model.period, model.n_periods, model.rem) == (
        3, 8, ("recurrent", "recurrent"))
    layers = model.param_tree(None)["layers"]
    assert len(layers) == 26
    assert [("rec" in p, "attn" in p) for p in layers] == [
        (model.kind(i) == "recurrent", model.kind(i) == "attention")
        for i in range(26)]
    assert [model.kind(i) for i in range(26)].count("attention") == 8
    assert cfg.hd == 256 and cfg.hd in tswa.HEAD_DIMS


def test_hybrid_prefill_logits_and_caches_match_reference():
    r = _lm()
    want, got = r["prefill"]
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    assert len(r["caches"]) == 10               # (h, conv) x 4, (k, v)
    for i, (jc, tc) in enumerate(r["caches"]):
        assert tc.shape == jc.shape, i
        _close(tc, jc, BLOCK_TOL)


def test_hybrid_decode_matches_reference_and_updates_caches_in_place():
    r = _lm()
    for i, (want, got) in enumerate(r["steps"]):
        _close(got, want, LOGIT_TOL)
        assert np.array_equal(got.argmax(-1), want.argmax(-1)), i
    for i, (jc, tc) in enumerate(r["decoded_cache"]):
        _close(tc, jc, BLOCK_TOL)


def test_hybrid_loss_matches_reference():
    want, got = _lm()["loss"]
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_hybrid_every_gradient_leaf_matches_reference():
    """Each reference leaf against the port's per-layer leaves (the
    periods' stacked leaves split by period); every leaf has a
    gradient."""
    r = _lm()
    flat = jax.tree_util.tree_flatten_with_path(r["jgrads"])[0]
    seen = set()
    for path, ref in flat:
        scale = np.abs(ref).max()
        assert scale > 0, path
        for name, want in _port_grad_names(path, ref):
            np.testing.assert_allclose(r["tgrads"][name], want, rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=name)
            seen.add(name)
    assert seen == set(r["tgrads"])


def test_hybrid_cache_is_constant_size_and_matches_the_spec():
    model = build(get_config(ARCH, True))
    small, big = model.cache_spec(2, 1_000), model.cache_spec(2, 1_000_000)
    shapes = [tuple(t.shape) for t in cache_leaves(small)]
    assert shapes == [tuple(t.shape) for t in cache_leaves(big)]
    assert small["periods"][0][0].dtype == torch.float32
    assert small["periods"][2][0].dtype == torch.bfloat16
    fp32 = build(get_config(ARCH, True).with_(dtype="float32"))
    spec = cache_leaves(fp32.cache_spec(2, 80))
    for (_, tc), s in zip(_lm()["caches"], spec):
        assert tc.shape == tuple(s.shape)


def test_params_from_numpy_maps_the_periods_and_rejects_a_missing_layer():
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(3)))
    tm = build(get_config(ARCH, True).with_(dtype="float32"))
    params_from_numpy(tm, params, "cpu")
    layers = tm.params["layers"]
    np.testing.assert_array_equal(
        layers[2]["attn"]["wq"]["w"].numpy(),
        params["layers"]["periods"]["l2"]["attn"]["wq"]["w"][0])
    np.testing.assert_array_equal(
        layers[4]["rec"]["lam"].numpy(), params["layers"]["rem1"]["rec"]["lam"])
    short = {**params, "layers": {k: v for k, v in params["layers"].items()
                                  if k != "rem1"}}
    with pytest.raises(ValueError, match="layers"):
        params_from_numpy(tm, short, "cpu")


def test_launch_train_first_loss_matches_reference(monkeypatch):
    """``launch.train --arch recurrentgemma-2b`` on the reduced config in
    fp32, from the reference's params: its first loss is the reference
    trainer's first-step loss on the same seed (tokens and labels drawn in
    its order)."""
    from repro_torch.configs import recurrentgemma_2b as cfg_mod
    monkeypatch.setattr(cfg_mod, "REDUCED",
                        cfg_mod.REDUCED.with_(dtype="float32"))
    jcfg = jget_config(ARCH, reduced=True).with_(dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    b = {k: jnp.asarray(rng.integers(0, jcfg.vocab, v.shape), jnp.int32)
         for k, v in jm.batch_spec(2, 96).items()}
    want = float(jm.loss(params, b)[0])
    out = tlaunch.train_lm("recurrentgemma-2b", reduced=True, steps=2,
                           batch=2, seq=96, seed=0, device="cpu",
                           params=jax.tree.map(np.asarray, params))
    assert out["losses"][0] == pytest.approx(want, rel=LOSS_RTOL)
    assert all(np.isfinite(out["losses"]))
    assert set(out["swa_launches"].values()) == {0}  # the plain versions


def test_launch_generate_reports_the_state_and_cache_bytes():
    out = tgenerate.main(["--arch", "recurrentgemma-2b", "--reduced",
                          "--device", "cpu", "--prompt-len", "70",
                          "--steps", "3"])
    cfg = get_config(ARCH, True)
    w, W = cfg.hybrid.lru_width, cfg.hybrid.window
    assert out["lru_state_bytes"] == 4 * 2 * w * 4
    assert out["conv_state_bytes"] == 4 * 2 * 3 * w * 2
    assert out["kv_cache_bytes"] == 2 * 2 * cfg.groups * W * cfg.hd * 2
    assert out["cache_bytes"] == (out["lru_state_bytes"]
                                  + out["conv_state_bytes"]
                                  + out["kv_cache_bytes"])
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 4) and ((ids >= 0) & (ids < cfg.padded_vocab)).all()
    assert out["swa_launches_prefill"] == 0          # the plain path here
    with pytest.raises(SystemExit, match="int8"):
        tgenerate.main(["--arch", "recurrentgemma-2b", "--reduced",
                        "--device", "cpu", "--kv-cache-dtype", "int8"])


# ------------------------- SWA at head dim 256 ------------------------ #
#: (B, Hq, Hkv, Sq, Skv, window, q_offset) at d = 256: recurrentgemma's
#: MQA (10 / 1 heads) with S past W, W >= S, ragged S with W not a
#: multiple of the key tile, q_offset with Sq < Skv
D256_CASES = [
    (1, 10, 1, 80, 80, 64, 0),
    (2, 4, 1, 40, 40, 64, 0),
    (1, 4, 2, 37, 37, 10, 0),
    (1, 4, 2, 20, 60, 24, 40),
]


@pytest.mark.parametrize("case", D256_CASES, ids=str)
def test_plain_backward_at_head_dim_256_matches_jax_vjp(case):
    """The port's plain forward, log-sum-exp and backward at d = 256,
    folded through the wrapper, against the reference's plain attention
    and ``jax.vjp`` of it."""
    B, hq, hkv, sq, skv, W, off = case
    d = 256
    rng = np.random.default_rng(sq + W)
    q = rng.standard_normal((B, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((B, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((B, hkv, skv, d), dtype=np.float32)
    do = rng.standard_normal((B, hq, sq, d), dtype=np.float32)
    o_ref, vjp = jax.vjp(lambda a, b, c: jref.swa_attention_ref(
        a, b, c, window=W, q_offset=off), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))

    def fold(x):
        return torch.from_numpy(np.ascontiguousarray(x)).reshape(
            -1, *x.shape[2:])
    o, lse = tswa.swa_attention_forward(fold(q), fold(k), fold(v), W, off,
                                        return_lse=True)
    _close(o.reshape(o_ref.shape), o_ref, PALLAS_TOL)
    got = tswa.swa_attention_backward(fold(q), fold(k), fold(v), o, lse,
                                      fold(do), W, off)
    for g, w in zip(got, want):
        _close(g.reshape(w.shape), w, PALLAS_TOL)


def test_model_swa_backward_at_head_dim_256_matches_jax_scan():
    """Gradients through ``models/attention.py``'s ``swa_attention`` at
    recurrentgemma's head dim (``SWAAttentionFn`` on CPU tensors) against
    ``jax.vjp`` of the zoo's jnp scan, which the reference trains
    through."""
    rng = np.random.default_rng(5)
    B, S, G, H, d, W = 1, 80, 1, 10, 256, 64
    q = rng.standard_normal((B, S, G, H, d), dtype=np.float32)
    k = rng.standard_normal((B, S, G, d), dtype=np.float32)
    v = rng.standard_normal((B, S, G, d), dtype=np.float32)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn.swa_attention(
        a, b, c, window=W, chunk_q=32), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tattn.swa_attention(tq, tk, tv, window=W).backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, PALLAS_TOL)


# ------------------------------- the card ----------------------------- #
def _card_d256(case, dtype, seed):
    B, hq, hkv, sq, skv, W, off = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(rows, s):
        return torch.randn((rows, s, 256), generator=gen,
                           device="cuda").to(dtype)
    return (rand(B * hq, sq), rand(B * hkv, skv), rand(B * hkv, skv),
            rand(B * hq, sq))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_kernels_match_plain_on_card(dtype):
    """The d = 256 forward (with its log-sum-exp) and the three backward
    kernels against the plain versions on the card, recurrentgemma's
    layer shape among the cases; one launch of each entry point a case,
    and two backward launches the same bits.  Skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    cases = D256_CASES + [(1, 10, 1, 4096, 4096, 2048, 0)]
    tswa.reset_launches()
    for n, case in enumerate(cases):
        W, off = case[5], case[6]
        q, k, v, do = _card_d256(case, dt, n)
        o, lse = tswa.swa_attention_forward(q, k, v, W, off, return_lse=True)
        o_p = tref.swa_attention_ref(q[None], k[None], v[None], W, off)[0]
        lse_p = tref.swa_attention_lse_ref(q[None], k[None], W, off)[0]
        tol = PALLAS_TOL if dt == torch.float32 else 1e-2 * (1 + o_p.abs())
        assert bool(((o.float() - o_p.float()).abs() <= tol).all())
        got = tswa.swa_attention_backward(q, k, v, o_p, lse_p, do, W, off)
        want = tref.swa_attention_backward_ref(
            q[None], k[None], v[None], o_p[None], lse_p[None], do[None], W,
            off)
        for g, w in zip(got, want):
            g, w = g.float(), w[0].float()
            tol = PALLAS_TOL if dt == torch.float32 else 1e-2 * (1 + w.abs())
            assert bool(((g - w).abs() <= tol).all())
        again = tswa.swa_attention_backward(q, k, v, o_p, lse_p, do, W, off)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    n = len(cases)
    assert tswa.launches == {"swa_attention_forward": n,
                             "swa_attention_bwd_dot": 2 * n,
                             "swa_attention_backward_dkdv": 2 * n,
                             "swa_attention_backward_dq": 2 * n}
