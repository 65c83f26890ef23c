"""The port's ``KGETrainer(mesh=)`` against the JAX package's, on the CPU.

All six models, 64 entities (divisible by the model axis) and a 3-row
relation table (whole on every rank, as GO's is on a 16-way axis), dim
16, batch 32, 4 negatives, 200 triples, a (2, 2) ("data", "model") mesh.

The reference's side runs once, in one subprocess with 4 forced host
devices, on a mesh built with the ``Mesh`` constructor (Auto axes):
``KGETrainer(model, cfg, mesh=)`` from its ``init``, 3 steps of its
jitted sharded step on the batches of its ``TripleLoader`` and the keys
``fit`` splits (``src/repro/kge/train.py:136-141``), each loss and the
params after the first step.  This process makes the same init, batches
and negatives (``repro.kge.negatives.corrupt`` on each key), and the port
runs the same steps, fed them (``step_with``), in a gloo world of 4 ranks
beside the subprocess, each rank holding its row shard of every
divisible table.

Held: each step's loss within 1e-5 relative of the reference's, the
params after step 1 within 2e-4 * max|p| of each table (gathered from
the ranks); the port's single-process trainer on the same inputs within
1e-6 of both.  Trained params are compared only over a few steps (ROADMAP
Queue 3 item 4).  And ``init`` + ``fit`` on the mesh against ``fit`` in
one process (the same generator draws): losses and final params within
1e-6.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kge import available_models, make_model, params_from_numpy
from repro_torch.kge.train import KGETrainer, TrainConfig
from repro_torch.launch.mesh import run_world

import _torch_mesh_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
N, N_REL, DIM, STEPS = 64, 3, 16, 3
CFG = dict(batch_size=32, num_negs=4, log_every=1)
LOSS_RTOL = 1e-5
PARAM_TOL = 2e-4          # times max|p| of the table
PORT_TOL = 1e-6
MODELS = ["transe", "transr", "distmult", "hole", "boxe", "rdf2vec"]

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.data.triples import TripleLoader
    from repro.kge import make_model
    from repro.kge.train import KGETrainer, TrainConfig

    N, N_REL, DIM, STEPS = 64, 3, 16, 3
    triples = np.load(sys.argv[1])
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    out = {}
    for name in sys.argv[3].split(","):
        cfg = TrainConfig(batch_size=32, num_negs=4)
        tr = KGETrainer(make_model(name, N, N_REL, dim=DIM), cfg, mesh=mesh)
        params, opt = tr.init()
        it = iter(TripleLoader(triples, cfg.batch_size, seed=cfg.seed))
        key = jax.random.key(cfg.seed + 1)
        for i in range(STEPS):
            key, sub = jax.random.split(key)
            batch = jnp.asarray(next(it))
            out[f"{name}/batch{i}"] = np.asarray(batch)
            params, opt, loss = tr._step(params, opt, batch, sub)
            out[f"{name}/loss{i}"] = np.asarray(loss)
            if i == 0:
                for k, v in params.items():
                    out[f"{name}/p1/{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _inputs(name, triples):
    """The reference's init, batches and negatives, as its ``fit`` makes
    them: ``model.init(key(seed))``, its ``TripleLoader``, and
    ``corrupt(sub)`` on each key ``fit`` splits from ``key(seed + 1)``."""
    import jax
    import jax.numpy as jnp
    from repro.data.triples import TripleLoader as JaxLoader
    from repro.kge import make_model as jmake_model
    from repro.kge.negatives import corrupt as jcorrupt
    cfg = TrainConfig(**CFG)
    init = jmake_model(name, N, N_REL, dim=DIM).init(jax.random.key(cfg.seed))
    it = iter(JaxLoader(triples, cfg.batch_size, seed=cfg.seed))
    key = jax.random.key(cfg.seed + 1)
    batches, rands, sides = [], [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        batch = jnp.asarray(next(it))
        h, _, t = jcorrupt(sub, batch, N, cfg.num_negs)
        # corrupt's own draws: the coin, then the entity on that side
        side = jax.random.bernoulli(jax.random.split(sub)[1], 0.5, h.shape)
        assert bool((jnp.where(side, t, h) == jnp.where(
            side, batch[:, 2:3], batch[:, 0:1])).all())
        batches.append(np.asarray(batch))
        rands.append(np.asarray(jnp.where(side, h, t)))
        sides.append(np.asarray(side))
    return ({k: np.asarray(v) for k, v in init.items()}, batches, rands,
            sides)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4-rank world, at once."""
    tmp = tmp_path_factory.mktemp("kge_mesh")
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(0, N, 200), rng.integers(0, N_REL, 200),
                        rng.integers(0, N, 200)], 1).astype(np.int32)
    np.save(tmp / "triples.npy", triples)
    cases = [(name, {"n": N, "n_rel": N_REL, "dim": DIM, "extra": {},
                     "id": name}) + _inputs(name, triples)
             for name in MODELS]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "triples.npy"),
         str(tmp / "ref.npz"), ",".join(MODELS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = run_world(ranks.kge_rank, 4, backend="gloo", devices="cpu",
                         args=(cases, CFG, triples, STEPS),
                         timeout_s=240)[0]
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))

    single = {}
    for name, _, init, batches, rands, sides in cases:
        for i, b in enumerate(batches):
            np.testing.assert_array_equal(ref[f"{name}/batch{i}"], b)
        model = make_model(name, N, N_REL, dim=DIM)
        tr = KGETrainer(model, TrainConfig(**CFG), device="cpu")
        params = params_from_numpy(model, init, "cpu")
        opt = tr.optimizer.init(params)
        losses, first = [], None
        for b, r, s in zip(batches, rands, sides):
            losses.append(float(tr.train_step.step_with(
                params, opt, torch.tensor(b).long(), torch.tensor(r).long(),
                torch.tensor(s))))
            if first is None:
                first = {k: v.numpy().copy() for k, v in params.items()}
        fit_params, _, stats = tr.fit(triples, steps=STEPS)
        single[name] = {"losses": losses, "params1": first,
                        "fit_losses": [l for _, l in stats["losses"]],
                        "fit_params": {k: v.numpy() for k, v in
                                       fit_params.items()}}
    want = {name: {"losses": [float(ref[f"{name}/loss{i}"])
                              for i in range(STEPS)],
                   "params1": {k[len(f"{name}/p1/"):]: v
                               for k, v in ref.items()
                               if k.startswith(f"{name}/p1/")}}
            for name in MODELS}
    return {"ref": want, "port": port, "single": single}


def test_every_model_is_covered():
    assert sorted(MODELS) == sorted(available_models())


@pytest.mark.parametrize("name", MODELS)
def test_losses_match_the_reference(runs, name):
    got, want = runs["port"][name]["losses"], runs["ref"][name]["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(runs["single"][name]["losses"], want,
                               rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_params_after_one_step_match_the_reference(runs, name):
    got, want = runs["port"][name]["params1"], runs["ref"][name]["params1"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=PARAM_TOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_the_mesh_matches_one_process(runs, name):
    got, want = runs["port"][name], runs["single"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=PORT_TOL,
                               atol=PORT_TOL)
    np.testing.assert_allclose(got["fit_losses"], want["fit_losses"],
                               rtol=PORT_TOL, atol=PORT_TOL)
    assert len(got["fit_losses"]) == STEPS
    for what in ("params1", "fit_params"):
        for k, w in want[what].items():
            np.testing.assert_allclose(got[what][k], w, rtol=PORT_TOL,
                                       atol=PORT_TOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", MODELS)
def test_tables_are_row_sharded_where_they_divide(runs, name):
    model = make_model(name, N, N_REL, dim=DIM)
    for k, shape in model.param_shapes().items():
        rows = shape[0] // 2 if shape[0] % 2 == 0 else shape[0]
        assert runs["port"][name]["shards"][k] == (rows,) + tuple(shape[1:])


def test_a_table_indexed_by_neither_vocabulary_is_refused():
    from repro_torch.launch.mesh import ProcessMesh
    model = make_model("transe", N, N_REL, dim=DIM)
    model.param_roles = lambda: {"entity": "entity", "relation": None}
    mesh = ProcessMesh(("data", "model"), (2, 2), (0, 0),
                       torch.device("cpu"), {})
    with pytest.raises(ValueError, match="neither"):
        KGETrainer(model, TrainConfig(**CFG), mesh=mesh)
