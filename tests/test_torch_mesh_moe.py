"""The port's expert-parallel MoE on a process mesh against the JAX
package's ``moe_apply_shard_map``, on the CPU.

The setup of ``tests/test_shard_map_moe.py``: reduced olmoe-1b-7b in
fp32, ``moe_dp_blocks`` 2, ``kv_groups`` 4, B 4, S 16, a (2, 4)
("data", "model") mesh, so each model rank holds one of the 4 experts.
The reference's side runs once, in one subprocess with 8 forced host
devices, on a mesh built with the ``Mesh`` constructor (Auto axes:
``jax.make_mesh``'s Explicit axes break the reference, ROADMAP Queue 3
item 6): its ``moe_impl`` "shard_map" and "gspmd" give the loss and
every gradient leaf of ``model.loss`` on the same params and batch.  The
port runs both impls in a gloo world of 8 ranks (``convert.shard_params``
cuts the attention, embedding and logits over ``"model"`` as the
reference lays them, and the experts for "shard_map"; "gspmd" keeps its
experts whole), the cut gradients gathered from the model ranks, and its
single-process ``moe_apply`` in this process.

Held: the loss within 1e-5 relative and every gradient leaf, element by
element, within 2e-4 * max|g| of its leaf (``tests/test_torch_moe.py``'s
tolerances), against the reference's shard_map and gspmd impls and the
port's single-process run.  A router gradient summed over ``"model"``
once too few or too many times (1/4 or 4x) fails it.

One ``make_train_step(mesh=)`` step (Adam at lr 1e-3 on each rank's
share) of each impl against the one-process ``make_train_step`` from the
same params: ``tests/test_torch_lm_train.py``'s rules for one step (the
loss within 1e-5 relative; mu within 2e-4 * max|mu| of its leaf, nu
within 4e-4 * max|nu|; the params within 1e-5 wherever |g| > 1e-3 *
max|g| of the leaf, and everywhere moved by at most lr * (1 + 1e-3)).

A (1, 2) case: one MoE layer's bf16 forward through
``moe_apply_shard_map`` on 2 ranks against the single-process bf16
``moe_apply`` on the same params and tokens (the router's op is the
same, so the routing is), y within the repo's bf16 tolerance 1e-2 (1 +
|y|) (``PERF.md`` §2), aux within 1e-6, the dropped pairs summed over the
ranks equal.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro_torch.launch.mesh import run_world
from repro_torch.models import blocks, build, get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.steps import make_train_step

import _torch_mesh_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
BF16_TOL = 1e-2           # times (1 + |y|)
PARAM_TOL = 1e-5
LR = 1e-3
B, S = 4, 16
CFG_KW = dict(dtype="float32", moe_dp_blocks=2, kv_groups=4)

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import build, get_config, runtime
    from repro.models.sharding import param_shardings

    data = np.load(sys.argv[1])
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    out = {}
    for impl in ("gspmd", "shard_map"):
        cfg = get_config("olmoe_1b_7b", reduced=True).with_(
            dtype="float32", moe_impl=impl, moe_dp_blocks=2, kv_groups=4)
        model = build(cfg)
        params = model.init(jax.random.key(0))
        with mesh, runtime.use_mesh(mesh if impl == "shard_map" else None):
            p_sh = param_shardings(cfg, mesh, params)
            b_sh = jax.tree.map(
                lambda l: NamedSharding(mesh, P("data", None)), batch)
            (loss, met), g = jax.jit(
                jax.value_and_grad(lambda p, b: model.loss(p, b),
                                   has_aux=True),
                in_shardings=(p_sh, b_sh))(params, batch)
        out[f"{impl}/loss"] = np.asarray(loss)
        out[f"{impl}/aux"] = np.asarray(met["aux"])
        for path, a in jax.tree_util.tree_flatten_with_path(g)[0]:
            out[f"{impl}/grad/" + ".".join(k.key for k in path)] = \\
                np.asarray(a)
    np.savez(sys.argv[2], **out)
""")


def _unstack(flat):
    """Reference leaves ``layers.<path>`` (L, ...) as the port's
    ``layers.<i>.<path>``."""
    out = {}
    for name, a in flat.items():
        if name.startswith("layers."):
            for i in range(a.shape[0]):
                out[f"layers.{i}.{name[len('layers.'):]}"] = a[i]
        else:
            out[name] = a
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 8-rank world, at once,
    on the reference's init (``model.init(jax.random.key(0))``)."""
    tmp = tmp_path_factory.mktemp("mesh_moe")
    jcfg = jget_config("olmoe_1b_7b", reduced=True).with_(
        dtype="float32", moe_dp_blocks=2, kv_groups=4)
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][rng.random((B, S)) < 0.1] = -1
    np.savez(tmp / "in.npz", **batch)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = run_world(ranks.moe_loss_rank, 8, backend="gloo",
                         devices="cpu", args=((2, 4), tree, batch, CFG_KW, LR),
                         timeout_s=240)[0]
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]

    cfg = get_config("olmoe_1b_7b", reduced=True).with_(**CFG_KW)
    model = params_from_numpy(build(cfg), tree, "cpu")
    model._p().requires_grad_(True)
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    single = {"loss": float(loss.detach()), "aux": float(met["aux"].detach()),
              "grads": {n: p.grad.numpy()
                        for n, p in model.params.named_parameters()}}
    model = params_from_numpy(build(cfg), tree, "cpu")
    step, opt = make_train_step(model, lr=LR)
    state = opt.init(dict(model.params.named_parameters()))
    state, met = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    single["step"] = {
        "step": state.step, "loss": float(met["loss"]),
        "params": {n: p.detach().numpy()
                   for n, p in model.params.named_parameters()},
        "mu": {n: t.numpy() for n, t in state.mu.items()},
        "nu": {n: t.numpy() for n, t in state.nu.items()}}
    return {"ref": dict(np.load(tmp / "ref.npz")), "port": port,
            "single": single, "tree": tree}


def _want(runs, against):
    if against == "single":
        return runs["single"]
    ref = runs["ref"]
    grads = {k[len(f"{against}/grad/"):]: v for k, v in ref.items()
             if k.startswith(f"{against}/grad/")}
    return {"loss": float(ref[f"{against}/loss"]),
            "aux": float(ref[f"{against}/aux"]), "grads": _unstack(grads)}


PAIRS = [("shard_map", "shard_map"), ("shard_map", "gspmd"),
         ("shard_map", "single"), ("gspmd", "gspmd"), ("gspmd", "single")]


@pytest.mark.parametrize("impl,against", PAIRS,
                         ids=[f"{a}-vs-{b}" for a, b in PAIRS])
def test_loss_matches(runs, impl, against):
    got, want = runs["port"][impl], _want(runs, against)
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert got["aux"] == pytest.approx(want["aux"], rel=LOSS_RTOL)
    assert got["aux"] > 0


@pytest.mark.parametrize("impl,against", PAIRS,
                         ids=[f"{a}-vs-{b}" for a, b in PAIRS])
def test_every_gradient_leaf_matches(runs, impl, against):
    got, want = runs["port"][impl]["grads"], _want(runs, against)["grads"]
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, name
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("impl", ["shard_map", "gspmd"])
def test_one_train_step_on_the_mesh_matches_one_process(runs, impl):
    got, want = runs["port"][impl]["step"], runs["single"]["step"]
    grads = runs["single"]["grads"]
    before = _unstack({".".join(k.key for k in path): a for path, a in
                       jax.tree_util.tree_flatten_with_path(runs["tree"])[0]})
    assert got["step"] == want["step"] == 1
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert set(got["params"]) == set(want["params"]) == set(grads)
    for name, p in want["params"].items():
        m, v = want["mu"][name], want["nu"][name]
        assert np.abs(got["mu"][name] - m).max() \
            <= GRAD_TOL * np.abs(m).max(), name
        assert np.abs(got["nu"][name] - v).max() \
            <= 2 * GRAD_TOL * np.abs(v).max(), name
        firm = np.abs(grads[name]) > 1e-3 * np.abs(grads[name]).max()
        np.testing.assert_allclose(got["params"][name][firm], p[firm],
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=name)
        assert np.abs(got["params"][name] - before[name]).max() \
            <= LR * (1 + 1e-3), name


def test_experts_are_cut_over_the_model_axis(runs):
    cfg = get_config("olmoe_1b_7b", reduced=True)
    assert runs["port"]["shard_map"]["experts"] == (1, cfg.d_model, cfg.d_ff)
    assert runs["port"]["gspmd"]["experts"] == (4, cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("impl", ["shard_map", "gspmd"])
def test_attention_is_cut_over_the_model_axis(runs, impl):
    """Each rank holds one of the 4 q heads' columns of ``wq``."""
    cfg = get_config("olmoe_1b_7b", reduced=True).with_(**CFG_KW)
    assert runs["port"][impl]["wq"] == (
        cfg.d_model, cfg.padded_heads() * cfg.hd // 4)


@pytest.mark.parametrize("impl", ["shard_map", "gspmd"])
def test_gathered_shares_are_the_full_params(runs, impl):
    """``convert.gather_params`` puts ``shard_params``' shares back: the
    reference's init, leaf for leaf."""
    want = _unstack({".".join(k.key for k in path): a for path, a in
                     jax.tree_util.tree_flatten_with_path(runs["tree"])[0]})
    got = runs["port"][impl]["params"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("factor", [0.25, 4.0])
def test_a_router_gradient_off_by_the_model_axis_fails(runs, factor):
    """The check above catches a router gradient summed over ``"model"``
    once too few (1/4) or too many (4x) times."""
    want = _want(runs, "shard_map")["grads"]
    for name in (n for n in want if n.endswith("moe.router")):
        bad = runs["port"]["shard_map"]["grads"][name] * factor
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(
                bad, want[name], rtol=0,
                atol=GRAD_TOL * np.abs(want[name]).max())


def test_bf16_layer_on_two_model_ranks_matches_single_process(runs):
    base = get_config("olmoe_1b_7b", reduced=True)
    kw = {"dtype": "bfloat16",          # C = 8 of 16 pairs an expert: drops
          "moe": dataclasses.replace(base.moe, capacity_factor=0.5)}
    cfg = base.with_(**kw)
    layer = {k: v[0] for k, v in runs["tree"]["layers"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    y, aux, drops = run_world(ranks.moe_layer_rank, 2, backend="gloo",
                              devices="cpu", timeout_s=120,
                              args=(layer, x, kw))[0]
    p = {k: torch.tensor(v, dtype=torch.bfloat16) for k, v in layer.items()}
    d = torch.zeros((), dtype=torch.int64)
    want, want_aux = blocks.moe_apply(p, torch.from_numpy(x).to(
        torch.bfloat16), cfg, d)
    want = want.float().numpy()
    assert np.isfinite(y).all() and y.shape == want.shape
    assert (np.abs(y - want) <= BF16_TOL * (1 + np.abs(want))).all(), \
        np.abs(y - want).max()
    assert abs(aux - float(want_aux)) <= 1e-6
    assert drops == int(d) > 0
