"""The port's sharded top-k against the JAX package's, on the CPU.

The reference's sharded path needs several devices, so it runs in one
subprocess with 4 forced host devices, on a mesh built with the ``Mesh``
constructor (its axes are Auto: ``jax.make_mesh`` makes Explicit axes,
which the reference's merge does not take).  The subprocess runs
``shard_table`` / ``shard_table_raw`` / ``topk_cosine_sharded`` (its ref
backend) on seeded inputs and writes the answers to an npz; each case
below holds the port's sharded call on ``ServingMesh.of((cpu,) * S)`` to
them: the same ``valid``, scores within 1e-5 (the reference's top-k
tolerance), and the same indices up to ``valid``: exactly those of the
port's unsharded call, and the reference's under the near-tie rule of
``tests/test_torch_topk.py`` (XLA and PyTorch sum a dot product in
another order, so at k in the thousands two rows 1 ulp apart may trade
places; only inside a run of reference scores closer than 1e-6, and
with the same set of ids).

Cases: S 2, 3, 4; N 1,001 (pad rows for every S) and 4,096 (pad rows for
S 3); k 1, 7, 64, 65, past a shard's rows, and N + 5 (clamped); with and
without norms; exclusions -1, at shard borders, the last real row and in
the pad.  In process: ties across shard borders (the lower global index
wins, as in one call), one shard, a table that does not divide.  The
engine: the port's sharded ``ServingEngine`` against the reference's on
the reference test's 33-row registry.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.registry import EmbeddingRegistry
from repro_torch.core.serving import ServingEngine
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ServingMesh
from test_torch_topk import _ids_agree

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
D = 24
Q = 7
CPU = torch.device("cpu")


def _ks(n, s):
    local = -(-n // s)
    return [1, 7, 64, 65, local + 3, n + 5]


CASES = [(s, n, k, bool(j % 2 == s % 2))
         for s in (2, 3, 4) for n in (1001, 4096)
         for j, k in enumerate(_ks(n, s))]


def _name(case):
    s, n, k, norms = case
    return f"S{s}-N{n}-k{k}-{'norms' if norms else 'unit'}"


def _excl(n, s):
    """-1, row 0, both sides of the first and last shard borders, the last
    real row, the first pad row (or past the table), one row past N."""
    local = -(-n // s)
    return np.array([-1, 0, local - 1, local, (s - 1) * local, n - 1, n],
                    np.int32)


def _inputs(n):
    rng = np.random.default_rng(n)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    raw = (rng.standard_normal((n, D)) * rng.uniform(0.5, 3.0, (n, 1))
           ).astype(np.float32)
    nrm = np.linalg.norm(raw, axis=1).astype(np.float32)
    return q, raw, nrm, raw / np.maximum(nrm[:, None], 1e-12)


SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.kernels import ops
    from repro.core.registry import EmbeddingRegistry
    from repro.core.serving import ServingEngine

    spec = json.load(open(sys.argv[1]))
    data = np.load(sys.argv[2])
    out = {}
    for s, n, k, norms in spec["cases"]:
        mesh = Mesh(np.array(jax.devices()[:s]), ("data",))
        q, excl = data[f"q{n}"], jnp.asarray(data[f"excl{n}_{s}"])
        name = f"{s}_{n}_{k}_{int(norms)}"
        if norms:
            es, ns, nv = ops.shard_table_raw(data[f"raw{n}"],
                                             data[f"nrm{n}"], mesh)
            out[f"table_{name}"] = np.asarray(es)
            out[f"norms_{name}"] = np.asarray(ns)
        else:
            es, nv = ops.shard_table(data[f"unit{n}"], mesh)
            ns = None
            out[f"table_{name}"] = np.asarray(es)
        sc, ix, va = ops.topk_cosine_sharded(
            jnp.asarray(q), es, k, exclude_rows=excl, mesh=mesh,
            n_valid=nv, use_pallas=False, norms=ns)
        out[f"s_{name}"], out[f"i_{name}"], out[f"v_{name}"] = (
            np.asarray(sc), np.asarray(ix), np.asarray(va))

    mesh = Mesh(np.array(jax.devices()), ("data",))
    reg = EmbeddingRegistry(spec["registry"])
    rng = np.random.default_rng(0)
    ids = [f"GO:{i:07d}" for i in range(33)]
    reg.publish("go", "v1", "transe", ids, [f"t {i}" for i in range(33)],
                rng.standard_normal((33, 12)).astype(np.float32),
                ontology_checksum="x", hyperparameters={"dim": 12})
    engine = ServingEngine(reg, mesh=mesh, use_pallas=False)
    answers = [[(c.identifier, c.score) for c in
                engine.closest_concepts("go", "transe", q, k=k)]
               for q, k in spec["queries"]]
    table_bytes = engine._index("go", "transe").device_table_bytes()
    np.savez(sys.argv[3], **out)
    print(json.dumps({"devices": jax.device_count(), "answers": answers,
                      "table_bytes": table_bytes}))
""")

QUERIES = [("GO:0000005", 40), ("GO:0000000", 10), ("GO:0000032", 1),
           ("GO:0000016", 32)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's answers for every case, from one subprocess."""
    tmp = tmp_path_factory.mktemp("sharded_topk")
    arrays = {}
    for n in (1001, 4096):
        q, raw, nrm, unit = _inputs(n)
        arrays.update({f"q{n}": q, f"raw{n}": raw, f"nrm{n}": nrm,
                       f"unit{n}": unit})
        for s in (2, 3, 4):
            arrays[f"excl{n}_{s}"] = _excl(n, s)
    np.savez(tmp / "in.npz", **arrays)
    (tmp / "spec.json").write_text(json.dumps({
        "cases": CASES, "registry": str(tmp / "registry"),
        "queries": QUERIES}))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "spec.json"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["devices"] == 4
    return dict(np.load(tmp / "in.npz")), dict(np.load(tmp / "out.npz")), \
        report, tmp / "registry"


def _mesh(s):
    return ServingMesh.of((CPU,) * s)


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_sharded_topk_matches_the_reference(reference, case):
    data, want, _, _ = reference
    s, n, k, norms = case
    name = f"{s}_{n}_{k}_{int(norms)}"
    q, excl = data[f"q{n}"], data[f"excl{n}_{s}"]
    mesh = _mesh(s)
    if norms:
        blocks, nblocks, nv = ops.shard_table_raw(data[f"raw{n}"],
                                                  data[f"nrm{n}"], mesh)
        assert np.array_equal(torch.cat(nblocks).numpy(),
                              want[f"norms_{name}"])
    else:
        blocks, nv = ops.shard_table(data[f"unit{n}"], mesh)
        nblocks = None
    assert nv == n and len(blocks) == s
    assert np.array_equal(torch.cat(blocks).numpy(), want[f"table_{name}"])
    sc, ix, va = ops.topk_cosine_sharded(q, blocks, k, exclude_rows=excl,
                                         mesh=mesh, n_valid=nv,
                                         norms=nblocks)
    one = ops.topk_cosine(q, torch.from_numpy(data[f"unit{n}"]), k,
                          exclude_rows=excl)
    assert torch.equal(va, one[2])
    for r in range(Q):
        assert torch.equal(ix[r, :va[r]], one[1][r, :va[r]])
    sc, ix, va = sc.numpy(), ix.numpy(), va.numpy()
    ws, wi, wv = want[f"s_{name}"], want[f"i_{name}"], want[f"v_{name}"]
    assert sc.shape == ix.shape == ws.shape == (Q, min(k, n))
    assert np.array_equal(va, wv)
    for r in range(Q):
        for lo, hi, span in _ids_agree(ix[r, :va[r]], wi[r, :wv[r]],
                                       ws[r, :wv[r]]):
            print(f"{_name(case)} row {r} near-tie run [{lo}, {hi}): "
                  f"{ix[r, lo:hi].tolist()} vs {wi[r, lo:hi].tolist()}, "
                  f"span {span:.3e}")
        np.testing.assert_allclose(sc[r, :va[r]], ws[r, :wv[r]], rtol=TOL,
                                   atol=TOL)
        assert (ix[r, :va[r]] < n).all()
        assert excl[r] not in ix[r, :va[r]]


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("k", [3, 9, 70])
def test_ties_across_shard_borders_go_to_the_lower_index(s, k):
    """Equal rows in every shard (scores exact in fp32, so equal in any
    summation order): the sharded call orders them by global index, as
    the unsharded call does."""
    rng = np.random.default_rng(s * 100 + k)
    n = 101
    e = rng.standard_normal((n, D)).astype(np.float32)
    local = -(-n // s)
    dup = [3] + [3 + j * local for j in range(1, s)] + [n - 1]
    e[dup] = 0.0
    e[dup, :4] = 1.0                          # norm 2: unit rows of 0.5s
    e[[10, 10 + local]] = -e[3]
    nrm = np.linalg.norm(e, axis=1).astype(np.float32)
    q = e[[3, 3, 10]] / nrm[[3, 3, 10], None]
    excl = np.array([3, -1, dup[1]], np.int32)
    blocks, nblocks, nv = ops.shard_table_raw(e, nrm, _mesh(s))
    sc, ix, va = ops.topk_cosine_sharded(q, blocks, k, exclude_rows=excl,
                                         mesh=_mesh(s), n_valid=nv,
                                         norms=nblocks)
    ws, wi, wv = ops.topk_cosine(q, torch.from_numpy(e), k,
                                 exclude_rows=excl, norms=nrm)
    assert torch.equal(va, wv)
    for r in range(3):
        assert torch.equal(ix[r, :va[r]], wi[r, :wv[r]])
        np.testing.assert_allclose(sc[r, :va[r]].numpy(),
                                   ws[r, :wv[r]].numpy(), rtol=TOL, atol=TOL)
    # the query's equal rows come first, in global order
    assert ix[1, :min(k, len(dup))].tolist() == dup[:k]
    assert ix[0, :min(k, len(dup) - 1)].tolist() == dup[1:k + 1]


def test_one_shard_is_the_unsharded_call():
    q, raw, nrm, _ = _inputs(1001)
    excl = _excl(1001, 2)
    for mesh in (None, _mesh(1)):
        blocks, nblocks, nv = (ops.shard_table_raw(raw, nrm, mesh)
                               if mesh else (torch.from_numpy(raw),
                                             torch.from_numpy(nrm), 1001))
        got = ops.topk_cosine_sharded(q, blocks, 65, exclude_rows=excl,
                                      mesh=mesh, n_valid=nv, norms=nblocks,
                                      device="cpu")
        want = ops.topk_cosine(q, torch.from_numpy(raw), 65,
                               exclude_rows=excl, norms=nrm)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_a_table_that_does_not_divide_raises():
    e = np.ones((10, 4), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        ops.topk_cosine_sharded(e[:1], e, 3, mesh=_mesh(3))


def test_sharded_engine_matches_the_references(reference):
    """The reference test's 33-row registry (published by the reference's
    registry; the port serves either package's store): the same
    identifiers, scores within 1e-5, the same device table bytes, and the
    join's slabs equal to one call a row."""
    _, _, report, root = reference
    sharded = ServingEngine(EmbeddingRegistry(root), device="cpu",
                            mesh=_mesh(4))
    solo = ServingEngine(EmbeddingRegistry(root), device="cpu")
    for (query, k), want in zip(QUERIES, report["answers"]):
        got = sharded.closest_concepts("go", "transe", query, k=k)
        assert [c.identifier for c in got] == [w[0] for w in want]
        np.testing.assert_allclose([c.score for c in got],
                                   [w[1] for w in want], rtol=TOL, atol=TOL)
        assert [c.identifier for c in got] == [
            c.identifier for c in solo.closest_concepts("go", "transe",
                                                        query, k=k)]
    index = sharded._index("go", "transe")
    assert index.device_table_bytes() == report["table_bytes"] == 36 * 13 * 4
    assert solo._index("go", "transe").device_table_bytes() == 0
    rows = list(range(33))
    joined = [hits for _, part in index.knn_join_rows(rows, k=5, slab=8)
              for hits in part]
    one = [index.top_k_rows([r], k=5)[0] for r in rows]
    assert [[c.identifier for c in h] for h in joined] == \
        [[c.identifier for c in h] for h in one]


def test_chip_smoke_shard_phase_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's shard phase on CPU shards at a 4,001 / 10,000-row
    table (the dry run it ends with is tested above, and stubbed here).
    Only the checks that hold on the card alone fail: the kernels'
    launch counts (the plain versions launch nothing), and equality with
    the unsharded call, since the CPU's matmul sums a row in another
    order at another shape while the kernel scores each pair alone."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.launch import dryrun
    failures = []
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(cs, "check", lambda ok, msg: ok or failures.append(
        msg))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_cuda_ms", lambda fn, **_: fn() and 0.0)
    monkeypatch.setattr(dryrun, "main", lambda argv: 0)
    monkeypatch.setattr(cs, "GO_ROWS", 4001)
    monkeypatch.setattr(cs, "SHARD_TABLES", ((4001, 4), (4001, 3),
                                             (10000, 3)))
    reg = EmbeddingRegistry(tmp_path)
    tables, served = {}, {}
    for ont, rows in (("go", 4001), ("go-scale", 10000)):
        ids, labels, emb = cs.go_table(rows, cs.SEED)
        reg.publish(ont, "2025-01", "transe", ids, labels, emb,
                    ontology_checksum="x", hyperparameters={"dim": cs.D})
        tables[rows] = reg.store.open_table(ont, "2025-01", "transe")[:2]
        served.setdefault("ids", ids)
    out = cs.phase_shard(str(tmp_path), served, tables, "cpu")
    by_design = ("missed a top-k entry point", "bodies differ from the "
                 "unsharded engine's", "differ from the unsharded kernel "
                 "call")
    assert [f for f in failures if not any(b in f for b in by_design)] == []
    assert len(out["cases"]) == 3 * len(cs.SHARD_QK)
    assert {c["pad_rows"] for c in out["cases"]} == {3, 1, 2}
    assert out["max_abs_err"] <= TOL and out["engine_requests"] == 54
    assert set(out["ms_q32_k10_40k"]) == {"sharded_4", "sharded_3",
                                          "streamed"}
