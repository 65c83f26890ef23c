"""The sequence-sharded residual (``seq_shard``, the reference's
``_maybe_seq_shard``) on a process mesh, on the CPU (gloo).

Reduced h2o-danube-1.8b in fp32 (S 96 > W 64), B 2, on the reference's
init (``model.init(jax.random.key(0))``, carried over by
``convert.params_from_numpy``).  The reference's side runs once, in one
subprocess with 4 forced host devices, beside the port's world: its
``model.loss`` and every gradient leaf with ``seq_shard=True`` under
``runtime.use_mesh`` on an Auto (2, 2) ("data", "model") ``Mesh`` built
with the constructor.  The port runs ``loss_and_grads`` with and without
``seq_shard`` in a (2, 2) gloo world.

Held: the port's ``seq_shard=True`` run against the reference's, the loss
within 1e-5 relative and every leaf within 2e-4 * max|g| of its leaf
(``tests/test_torch_lm_train.py``'s tolerances across the packages);
against the port's ``seq_shard=False`` run on the same params and batch,
the loss and every leaf within 1e-6 (the blocks compute the same sums;
only the residual between them is split), both against the port's
single-process run within 1e-6; each checkpointed block is given (and so
remat keeps) B / 2 x S / 2 residual rows with it, B / 2 x S without; a
sequence the model axis does not divide raises ``ValueError``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro_torch.launch.mesh import run_world
from repro_torch.models import build, get_config
from repro_torch.models.convert import params_from_numpy

import _torch_mesh_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6
LOSS_RTOL = 1e-5          # against the reference
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
B, S = 2, 96

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import build, get_config, runtime

    data = np.load(sys.argv[1])
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    cfg = get_config("h2o_danube_1_8b", reduced=True).with_(
        dtype="float32", seq_shard=True)
    model = build(cfg)
    params = model.init(jax.random.key(0))
    with mesh, runtime.use_mesh(mesh):
        b_sh = jax.tree.map(
            lambda l: NamedSharding(mesh, P("data", None)), batch)
        (loss, _), g = jax.jit(
            jax.value_and_grad(lambda p, b: model.loss(p, b), has_aux=True),
            in_shardings=(None, b_sh))(params, batch)
    out = {"loss": np.asarray(loss)}
    for path, a in jax.tree_util.tree_flatten_with_path(g)[0]:
        out["grad/" + ".".join(k.key for k in path)] = np.asarray(a)
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
    """The reference's subprocess and the port's 4-rank world, at once,
    and the port's single-process run."""
    tmp = tmp_path_factory.mktemp("seq_shard")
    out = {}
    jcfg = jget_config("h2o_danube_1_8b", reduced=True).with_(dtype="float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][rng.random((B, S)) < 0.1] = -1
    np.savez(tmp / "in.npz", **batch)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out["mesh"] = run_world(ranks.seq_shard_rank, 4, backend="gloo",
                                devices="cpu", args=(tree, batch),
                                timeout_s=180)[0]
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    out["ref"] = {"loss": float(ref["loss"]), "grads": _unstack(
        {k[len("grad/"):]: v for k, v in ref.items()
         if k.startswith("grad/")})}
    cfg = get_config("h2o_danube_1_8b", reduced=True).with_(dtype="float32")
    model = params_from_numpy(build(cfg), tree, "cpu")
    model._p().requires_grad_(True)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    out["single"] = {"loss": float(loss.detach()),
                     "grads": {n: p.grad.numpy() for n, p in
                               model.params.named_parameters()}}
    out["cfg"] = cfg
    return out


def test_seq_shard_matches_the_reference(runs):
    got, want = runs["mesh"][True], runs["ref"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(got["grads"][name], w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("got,want", [(True, False), (True, "single"),
                                      (False, "single")])
def test_loss_and_every_leaf_match(runs, got, want):
    a = runs["mesh"][got]
    b = runs["single"] if want == "single" else runs["mesh"][want]
    assert a["loss"] == pytest.approx(b["loss"], rel=TOL, abs=TOL)
    assert set(a["grads"]) == set(b["grads"])
    for name, g in b["grads"].items():
        np.testing.assert_allclose(a["grads"][name], g, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("seq", [True, False])
def test_each_block_keeps_the_ranks_rows(runs, seq):
    cfg = runs["cfg"]
    saved = runs["mesh"][seq]["saved"]
    rows = S // 2 if seq else S
    assert saved == [(B // 2, rows, cfg.d_model)] * cfg.n_layers


def test_a_sequence_the_model_axis_does_not_divide_raises(runs):
    assert "does not divide" in runs["mesh"]["odd"]
