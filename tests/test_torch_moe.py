"""The port's MoE block and ``MoELM`` against the JAX package's.

fp32 throughout (``dtype="float32"``).  The reference's params, drawn from
its key, are carried into the port (as tensors, or by
``models.convert.params_from_numpy``), and the same inputs, made by numpy
from a seed, go through both.

- The cases of ``tests/test_moe.py``, against the port: the dense
  equivalence at large capacity (1e-4, that file's tolerance), drops that
  shrink the output and never make a NaN, the aux loss that penalises
  imbalance, gradients that reach the router and every expert.
- ``moe_apply`` against the reference's, with and without
  ``moe_ff_split = 2``: the routing (expert ids, kept pairs, buffer slots)
  compared apart from the outputs; y within 1e-5 of max|y|; aux within
  1e-6.  A token may route differently only where the reference's K-th
  and (K+1)-th probabilities lie within 1e-6 (a near-tie: rounding
  decides it); such tokens are printed and left out of y's comparison.
- The router's ties: exactly equal probabilities go to the lower expert
  index, as ``jax.lax.top_k`` sends them.
- Reduced olmoe-1b-7b and grok-1-314b as ``MoELM`` against the
  reference's model: prefill and ``decode_step`` logits within 2e-4 (the
  dense LMs' ``LOGIT_TOL``), the loss within 1e-5 relative and every
  gradient leaf within 2e-4 * max|g_ref| of its leaf
  (``tests/test_torch_lm_train.py``'s tolerances).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro.models.config import ArchConfig as JArchConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.models import build, get_config, get_model
from repro_torch.models import blocks as tblocks
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.moe import MoELM

Y_TOL = 1e-5              # times max|y_ref|
AUX_TOL = 1e-6
NEAR_TIE = 1e-6           # K-th vs (K+1)-th reference probability
LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
MOE_ARCHS = ("olmoe_1b_7b", "grok_1_314b")


def _cfgs(E=4, k=2, cf=8.0, d=32, ff=64, split=0, blocks=0):
    kw = dict(arch_id="moe-t", family="moe", n_layers=1, d_model=d,
              n_heads=4, n_kv_heads=2, d_ff=ff, vocab=64, dtype="float32",
              moe_ff_split=split, moe_dp_blocks=blocks)
    return (JArchConfig(moe=JMoEConfig(n_experts=E, top_k=k,
                                       capacity_factor=cf), **kw),
            ArchConfig(moe=MoEConfig(n_experts=E, top_k=k,
                                     capacity_factor=cf), **kw))


def _params(jcfg, seed=0):
    """The reference's ``moe_init`` params, as jnp and as torch."""
    p = jblocks.moe_init(jax.random.key(seed), jcfg)
    return p, {n: torch.tensor(np.asarray(a)) for n, a in p.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _dense_reference(p, x, cfg):
    """Every token through its top-k experts, no capacity limit (the
    oracle of tests/test_moe.py, in torch on the port's params)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ p["router"], -1)
    w, idx = torch.topk(probs, cfg.moe.top_k)
    w = w / w.sum(-1, keepdim=True)
    g = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf, p["gate"]))
    u = torch.einsum("td,edf->tef", xf, p["up"])
    o = torch.einsum("tef,efd->ted", g * u, p["down"])
    sel = torch.gather(o, 1, idx[..., None].expand(-1, -1, d))
    return (sel * w[..., None]).sum(1).reshape(B, S, d)


# ------------------------ tests/test_moe.py's cases ------------------- #
def test_moe_matches_dense_reference_with_big_capacity():
    _, cfg = _cfgs(cf=8.0)
    _, p = _params(_cfgs(cf=8.0)[0])
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    y, aux = tblocks.moe_apply(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), _dense_reference(p, x, cfg).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert math.isfinite(float(aux))


def test_moe_capacity_drops_are_partial_not_nan():
    jcfg, cfg = _cfgs(cf=0.25)
    _, p = _params(jcfg)
    x = torch.from_numpy(_x((2, 32, cfg.d_model)))
    drops = torch.zeros((), dtype=torch.int64)
    y, aux = tblocks.moe_apply(p, x, cfg, drops)
    assert bool(torch.isfinite(y).all()) and math.isfinite(float(aux))
    assert float(y.norm()) < float(_dense_reference(p, x, cfg).norm())
    # C = ceil(64 * 2 / 4 * 0.25) = 8 an expert: at most 32 of 128 kept
    _, _, _, keep, _, C = tblocks.moe_route(p, x, cfg)
    assert C == 8 and int(keep.sum()) <= 32
    assert int(drops) == int((~keep).sum()) >= 96


def test_moe_aux_loss_penalizes_imbalance():
    jcfg, cfg = _cfgs(E=4, k=1)
    _, p = _params(jcfg)
    router = torch.zeros((cfg.d_model, 4))
    router[:, 0] = 10.0 / cfg.d_model
    x = torch.from_numpy(np.abs(_x((1, 32, cfg.d_model))))
    _, aux_skew = tblocks.moe_apply(dict(p, router=router), x, cfg)
    _, aux_unif = tblocks.moe_apply(dict(p, router=torch.zeros_like(router)),
                                    x, cfg)
    assert float(aux_skew) > float(aux_unif)
    assert abs(float(aux_unif) - 1.0) < 0.2   # balanced => ~1


def test_moe_grad_flows_to_router_and_experts():
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    p = {n: t.requires_grad_(True) for n, t in p.items()}
    x = torch.from_numpy(_x((1, 8, cfg.d_model)))
    y, aux = tblocks.moe_apply(p, x, cfg)
    ((y ** 2).sum() + aux).backward()
    for name in ("router", "gate", "up", "down"):
        assert float(p[name].grad.abs().max()) > 0, name


# ----------------------- moe_apply against the reference --------------- #
def _jax_routing(p, x, cfg):
    """The reference's routing, as its ``moe_apply`` computes it (one
    dispatch block): probs, idx, keep, slot."""
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    Ev, _, r = jblocks._moe_dims(cfg)
    T = B * S
    logits = (x.reshape(1, T, d) @ p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    if r > 1:
        idx = (idx[..., None] * r + jnp.arange(r)).reshape(1, T, K * r)
        E, K = Ev, K * r
    C = max(1, int(math.ceil(T * K / E * cfg.moe.capacity_factor)))
    flat = idx.reshape(1, T * K)
    rank = jnp.cumsum(jax.nn.one_hot(flat, E, dtype=jnp.int32), axis=1) - 1
    rank = jnp.take_along_axis(rank, flat[..., None], axis=2)[..., 0]
    keep = rank < C
    slot = jnp.where(keep, flat * C + rank, E * C)
    return (np.asarray(probs[0]), np.asarray(idx[0]), np.asarray(keep[0]),
            np.asarray(slot[0]))


def _near_tied(probs, k):
    """Tokens whose k-th and (k+1)-th largest probabilities lie within
    NEAR_TIE."""
    top = -np.sort(-probs, axis=-1)
    if k >= probs.shape[-1]:
        return np.zeros(probs.shape[0], bool)
    return top[:, k - 1] - top[:, k] <= NEAR_TIE


CASES = [dict(), dict(split=2), dict(cf=1.0), dict(cf=0.5, split=2),
         dict(E=8, k=3, cf=1.25, d=48, ff=96)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()) or "default")
def test_moe_apply_matches_reference(case):
    jcfg, cfg = _cfgs(**case)
    jp, p = _params(jcfg, seed=2)
    x = _x((2, 24, cfg.d_model), seed=3)
    jy, jaux = jblocks.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = tblocks.moe_apply(p, torch.from_numpy(x), cfg)
    probs_r, idx_r, keep_r, slot_r = _jax_routing(jp, jnp.asarray(x), jcfg)
    probs, _, idx, keep, slot, _ = tblocks.moe_route(p, torch.from_numpy(x),
                                                     cfg)
    np.testing.assert_allclose(probs[0].numpy(), probs_r, rtol=0, atol=1e-6)
    tied = _near_tied(probs_r, cfg.moe.top_k)
    if tied.any():
        print(f"near-tied tokens (K-th and (K+1)-th within {NEAR_TIE}), "
              f"excepted: {np.flatnonzero(tied).tolist()}")
    # routing, apart from the outputs: every token's experts, kept pairs
    # and buffer slots, but for near-tied tokens
    K = idx.shape[-1]
    pairs = np.repeat(~tied, K)
    assert np.array_equal(idx[0].numpy()[~tied], idx_r[~tied])
    assert np.array_equal(keep[0].numpy()[pairs], keep_r[pairs])
    assert np.array_equal(slot[0].numpy()[pairs], slot_r[pairs])
    y, jy = y.numpy().reshape(-1, cfg.d_model), np.asarray(jy).reshape(
        -1, cfg.d_model)
    np.testing.assert_allclose(y[~tied], jy[~tied], rtol=0,
                               atol=Y_TOL * np.abs(jy).max())
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


def test_moe_dp_blocks_dispatch_each_block_alone():
    """``moe_dp_blocks`` = 2: each block routes its own tokens with its own
    capacity; y equals each half through one block, aux their mean (the
    reference constrains this buffer to a mesh, so it is checked here
    against the port's single block)."""
    _, cfg2 = _cfgs(cf=1.0, blocks=2)
    jcfg, cfg1 = _cfgs(cf=1.0)
    _, p = _params(jcfg, seed=4)
    x = torch.from_numpy(_x((2, 16, cfg1.d_model), seed=5))
    y, aux = tblocks.moe_apply(p, x, cfg2)
    halves = [tblocks.moe_apply(p, x[i:i + 1], cfg1) for i in range(2)]
    torch.testing.assert_close(y, torch.cat([h[0] for h in halves]),
                               rtol=0, atol=1e-6)
    assert abs(float(aux) - float(sum(h[1] for h in halves)) / 2) <= AUX_TOL


@pytest.mark.parametrize("split", [0, 2])
def test_router_ties_go_to_the_lower_expert(split):
    """Exactly equal probabilities: every expert (a zero router), and two
    equal router columns (experts 1 and 3, and 0 and 2)."""
    jcfg, cfg = _cfgs(E=4, k=2, split=split)
    jp, p = _params(jcfg, seed=6)
    x = _x((1, 12, cfg.d_model), seed=7)
    for router in (np.zeros((cfg.d_model, 4), np.float32),
                   np.asarray(jp["router"])[:, [0, 1, 0, 1]]):
        jq = dict(jp, router=jnp.asarray(router))
        _, idx_r, keep_r, slot_r = _jax_routing(jq, jnp.asarray(x), jcfg)
        _, _, idx, keep, slot, _ = tblocks.moe_route(
            dict(p, router=torch.from_numpy(router)), torch.from_numpy(x),
            cfg)
        assert np.array_equal(idx[0].numpy(), idx_r)
        assert np.array_equal(slot[0].numpy(), slot_r)
        first = idx_r[:, 0] // max(1, split)
        assert (first <= 1).all()   # a tie's lower member ranks first
        jy, jaux = jblocks.moe_apply(jq, jnp.asarray(x), jcfg)
        y, aux = tblocks.moe_apply(dict(p, router=torch.from_numpy(router)),
                                   torch.from_numpy(x), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=Y_TOL * np.abs(np.asarray(jy)).max())
        assert abs(float(aux) - float(jaux)) <= AUX_TOL


# ------------------------------ blocks -------------------------------- #
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_blocks_match_reference(arch):
    """``moe_block_apply`` (with its aux), ``moe_block_prefill`` and
    ``moe_block_decode`` (a per-layer cache, the new slot written at pos)
    on the reference's block params, reduced config in fp32: outputs
    within 2e-4, caches within 1e-5, aux within 1e-6."""
    jcfg = jget_config(arch, reduced=True).with_(dtype="float32")
    tcfg = get_config(arch, reduced=True).with_(dtype="float32")
    jp = jblocks.moe_block_init(jax.random.key(9), jcfg)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = _x((2, 40, tcfg.d_model), seed=10)
    jy, jaux = jblocks.moe_block_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tblocks.moe_block_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    jy, jk, jv = jblocks.moe_block_prefill(jp, jnp.asarray(x), jcfg)
    ty, tk, tv = tblocks.moe_block_prefill(tp, torch.from_numpy(x), tcfg)
    for got, want, tol in ((ty, jy, LOGIT_TOL), (tk, jk, 1e-5),
                           (tv, jv, 1e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
    one = _x((2, 1, tcfg.d_model), seed=11)
    kc = np.pad(np.asarray(jk), ((0, 0), (0, 0), (0, 8), (0, 0)))
    vc = np.pad(np.asarray(jv), ((0, 0), (0, 0), (0, 8), (0, 0)))
    jy, jk, jv = jblocks.moe_block_decode(jp, jnp.asarray(one),
                                          jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(40), jcfg)
    ty, tk, tv = tblocks.moe_block_decode(
        tp, torch.from_numpy(one), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), 40, tcfg)
    for got, want, tol in ((ty, jy, LOGIT_TOL), (tk, jk, 1e-5),
                           (tv, jv, 1e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


# ------------------------------ MoELM ---------------------------------- #
@pytest.mark.parametrize("arch,reduced", [("olmoe-1b-7b", False),
                                          ("olmoe-1b-7b", True),
                                          ("grok-1-314b", True)])
def test_zoo_builds_moe_lms(arch, reduced):
    cfg, model = get_model(arch, reduced=reduced)
    assert isinstance(model, MoELM) and cfg.family == "moe"
    assert cfg.n_active_params() == jget_config(arch,
                                                reduced).n_active_params()
    if not reduced:
        # 64 x 3 x 2048 x 1024 x 16 expert weights, ~6.9B in all
        assert 6.8e9 < cfg.n_params() < 7.0e9
        assert cfg.hd == 128


_LM: dict = {}


def _lm(arch):
    """Both packages' reduced model on the same params and tokens: prefill
    logits, one decode step's, the loss and its gradients."""
    if arch in _LM:
        return _LM[arch]
    jcfg = jget_config(arch, reduced=True).with_(dtype="float32")
    tcfg = get_config(arch, reduced=True).with_(dtype="float32")
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.key(11))
    params_from_numpy(tm, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(12)
    B, S = 2, 40
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.1] = -1
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                        cache_len=S + 1)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks)}, cache_len=S + 1)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jd, _ = jm.decode_step(params, jc, jnp.asarray(tok),
                           jnp.asarray(S, jnp.int32))
    td, _ = tm.decode_step(tc, torch.from_numpy(tok), S)
    batch = {"tokens": toks, "labels": labels}
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    tm._p().requires_grad_(True)
    tloss, tmet = tm.loss(jax.tree.map(torch.from_numpy, batch))
    tloss.backward()
    out = {"cfg": tcfg, "prefill": (np.asarray(jl), tl.numpy()),
           "decode": (np.asarray(jd), td.numpy()),
           "loss": (float(jloss), float(tloss.detach())),
           "aux": (float(jmet["aux"]), float(tmet["aux"].detach())),
           "jgrads": jax.tree.map(np.asarray, jg),
           "tgrads": {n: t.grad.numpy()
                      for n, t in tm.params.named_parameters()}}
    _LM[arch] = out
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_moelm_logits_match_reference(arch, what):
    want, got = _lm(arch)[what]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moelm_loss_matches_reference(arch):
    r = _lm(arch)
    assert r["loss"][1] == pytest.approx(r["loss"][0], rel=LOSS_RTOL)
    assert r["aux"][1] == pytest.approx(r["aux"][0], rel=LOSS_RTOL)
    assert r["aux"][1] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moelm_every_gradient_leaf_matches_reference(arch):
    """Each stacked reference leaf ``(L, ...)`` against the port's per-layer
    leaves ``layers.i.<path>``; every leaf has a gradient."""
    r = _lm(arch)
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


def test_moelm_counts_dropped_pairs():
    """Reduced olmoe at its capacity factor: prefill drops some (token,
    slot) pairs and counts them on the device; ``take_dropped`` reads and
    clears the count; decode at B = 2 (C = 2 here) drops none."""
    cfg = get_config("olmoe-1b-7b", reduced=True).with_(dtype="float32")
    model = build(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (2, 48)).astype(np.int32))
    _, cache = model.prefill({"tokens": toks}, cache_len=49)
    dropped = model.take_dropped()
    assert dropped > 0 and model.take_dropped() == 0
    model.decode_step(cache, toks[:, -1:], 48)
    assert model.take_dropped() == 0


@pytest.mark.cuda
def test_reduced_olmoe_runs_the_causal_kernel_on_card():
    """Reduced olmoe on the card in fp32: one SWA forward launch a layer
    of the prefill (the causal band, W = S), logits within 2e-4 of the
    CPU plain path on the same params; skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import swa_attention as tswa
    jcfg = jget_config("olmoe_1b_7b", reduced=True).with_(dtype="float32")
    tcfg = get_config("olmoe_1b_7b", reduced=True).with_(dtype="float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(11)))
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab, (2, 48)).astype(np.int32))
    logits = {}
    for dev in ("cpu", "cuda"):
        model = params_from_numpy(build(tcfg), tree, dev)
        tswa.reset_launches()
        out, cache = model.prefill({"tokens": toks.to(dev)}, cache_len=49)
        step, _ = model.decode_step(cache, toks[:, -1:].to(dev), 48)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tswa.launches["swa_attention_forward"] == tcfg.n_layers
        logits[dev] = (out.cpu().numpy(), step.cpu().numpy())
    for got, want in zip(logits["cuda"], logits["cpu"]):
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


# ----------------------------- launchers ------------------------------ #
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "grok-1-314b"])
def test_launch_train_moe_first_loss_matches_reference(arch, monkeypatch):
    """``launch.train --arch`` on a reduced MoE arch in fp32 (the config
    module's ``REDUCED`` swapped for its fp32 copy), from the reference's
    params: its first loss (cross-entropy + 0.01 aux) is the reference's
    ``model.loss`` on the batch ``repro.launch.train.train_lm`` draws
    first from the same seed."""
    import importlib
    from repro_torch.launch import train as tlaunch
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    monkeypatch.setattr(mod, "REDUCED", mod.REDUCED.with_(dtype="float32"))
    jcfg = jget_config(arch, reduced=True).with_(dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, jcfg.vocab, v.shape), jnp.int32)
             for k, v in jm.batch_spec(2, 32).items()}
    want = float(jm.loss(params, batch)[0])
    out = tlaunch.train_lm(arch, reduced=True, steps=2, batch=2, seq=32,
                           seed=0, device="cpu",
                           params=jax.tree.map(np.asarray, params))
    assert out["losses"][0] == pytest.approx(want, rel=LOSS_RTOL)
    assert all(np.isfinite(out["losses"]))


def test_launch_generate_moe_reports_dropped_pairs():
    from repro_torch.launch import generate
    out = generate.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                         "cpu", "--prompt-len", "48", "--steps", "3"])
    ids = np.asarray(out["ids"])
    assert ids.shape == (2, 4) and ((ids >= 0) & (ids < get_config(
        "olmoe-1b-7b", True).padded_vocab)).all()
    assert out["dropped_prefill"] > 0          # C = 60 an expert, 192 pairs
    assert out["dropped_per_decode_step"] == 0   # C = 2 at batch 2
    assert out["swa_launches_prefill"] == 0      # the plain path here
    with pytest.raises(SystemExit, match="dense"):
        generate.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                       "cpu", "--kv-cache-dtype", "int8"])
