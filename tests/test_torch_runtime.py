"""The port's process mesh and runtime collectives, on the CPU (gloo).

- ``runtime.use_mesh`` / ``get_mesh``: nesting, and the previous mesh back
  on exit, also on an exception (the reference's contract).
- ``ProcessMesh`` in a 4-rank world: each rank's coordinates (row-major,
  as ``Mesh(np.array(devices).reshape(2, 2), ("data", "model"))`` lays
  devices out), its index along each set of axes and the ranks of the
  three groups it keeps (``"model"``, the data axes, all axes); a (pod,
  data, model) = (2, 1, 2) mesh in the same world.
- Each autograd collective's forward and backward against sums computed
  by hand: ``psum_identity_bwd`` (sum, identity), ``pvary`` (identity,
  sum), ``pmean`` (mean, / n), ``gather_seq`` / ``slice_seq`` (each the
  other's backward), ``gather_last`` (this rank's block of the
  cotangent) and ``gather_last_summed`` (its block of the cotangents'
  sum), ``take_share`` / ``gather_share``.
- ``run_world``: a rank that raises fails the call with its traceback,
  at once; a rank that hangs fails it at the time limit.
"""
import numpy as np
import pytest

from repro_torch.launch.mesh import MeshShape, ProcessMesh, run_world
from repro_torch.models import runtime
from repro_torch.models.sharding import param_pspec, shard_shape

import _torch_mesh_ranks as ranks

WORLD = 4


def test_use_mesh_nests_and_restores():
    a, b = object(), object()
    assert runtime.get_mesh() is None
    with runtime.use_mesh(a):
        assert runtime.get_mesh() is a
        with runtime.use_mesh(b):
            assert runtime.get_mesh() is b
            with runtime.use_mesh(None):
                assert runtime.get_mesh() is None
            assert runtime.get_mesh() is b
        assert runtime.get_mesh() is a
        with pytest.raises(KeyError):
            with runtime.use_mesh(b):
                raise KeyError("inside")
        assert runtime.get_mesh() is a
    assert runtime.get_mesh() is None


def test_process_mesh_takes_the_sharding_rules():
    """Without a world: the ``axis_names`` / ``shape`` surface the rules
    read, the same as a ``MeshShape``'s."""
    from repro_torch.models import get_config
    mesh = ProcessMesh(("data", "model"), (2, 4), (1, 3), None, {})
    shape = MeshShape(("data", "model"), (2, 4))
    cfg = get_config("olmoe_1b_7b", reduced=True)
    spec = param_pspec(cfg, ("layers", "0", "moe", "gate"), 3, 4)
    assert mesh.shape == shape.shape and mesh.size == shape.size == 8
    assert shard_shape((4, 256, 128), spec, mesh) == \
        shard_shape((4, 256, 128), spec, shape) == (1, 256, 128)
    assert mesh.index("model") == 3 and mesh.index("data") == 1
    assert mesh.index(("data", "model")) == 7
    with pytest.raises(ValueError):
        mesh.index("pod")


_OUT = {}


def _world():
    if not _OUT:
        _OUT["r"] = run_world(ranks.runtime_rank, WORLD, backend="gloo",
                              devices="cpu", timeout_s=120)
    return _OUT["r"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_coordinates_and_axis_groups(rank):
    r = _world()[rank]
    d, m = divmod(rank, 2)
    assert r["coords"] == (d, m) and r["shape"] == {"data": 2, "model": 2}
    assert r["index"] == {"data": d, "model": m, ("data", "model"): rank}
    assert r["groups"] == {("data",): [m, 2 + m],
                           ("model",): [2 * d, 2 * d + 1],
                           ("data", "model"): [0, 1, 2, 3]}
    pod = r["pod"]
    assert pod["coords"] == (d, 0, m) and pod["index"] == d
    assert pod["groups"] == {("model",): [2 * d, 2 * d + 1],
                             ("pod", "data"): [m, 2 + m],
                             ("pod", "data", "model"): [0, 1, 2, 3]}
    assert "no group of axes ('pod',)" in pod["no_group"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_collectives_forward_and_backward(rank):
    r = _world()[rank]
    d = rank // 2
    pair = [2 * d + 1.0, 2 * d + 2.0]          # v = rank + 1 on the group
    v = rank + 1.0
    y, g = r["psum"]
    np.testing.assert_array_equal(y, np.full(3, sum(pair)))
    np.testing.assert_array_equal(g, np.full(3, v))        # identity
    y, g = r["pvary"]
    np.testing.assert_array_equal(y, np.full(3, 2.0))
    np.testing.assert_array_equal(g, np.full(3, sum(pair)))  # summed
    y, g = r["pmean"]
    assert y == 2.5 and g == 3.0 / 4
    y, g = r["gather_seq"]
    np.testing.assert_array_equal(
        y, np.repeat(np.asarray(pair), 4).reshape(1, 4, 2))
    m = rank % 2
    np.testing.assert_array_equal(
        g, np.arange(8.0).reshape(1, 4, 2)[:, 2 * m:2 * m + 2])
    y, g = r["slice_seq"]
    np.testing.assert_array_equal(
        y, np.arange(8.0).reshape(1, 4, 2)[:, 2 * m:2 * m + 2])
    np.testing.assert_array_equal(
        g, np.repeat(np.asarray(pair), 4).reshape(1, 4, 2))
    # the cotangent of gather_last* is arange(12).view(2, 6) * v
    block = np.arange(12.0).reshape(2, 6)[:, 3 * m:3 * m + 3]
    y, g = r["gather_last"]
    np.testing.assert_array_equal(
        y, np.repeat(np.asarray(pair), 3)[None].repeat(2, 0))
    np.testing.assert_array_equal(g, block * v)
    y, g = r["gather_last_summed"]
    np.testing.assert_array_equal(
        y, np.repeat(np.asarray(pair), 3)[None].repeat(2, 0))
    np.testing.assert_array_equal(g, block * sum(pair))


@pytest.mark.parametrize("rank", range(WORLD))
def test_shares_cut_and_gather_back(rank):
    share, both, full1, full2, full3 = _world()[rank]["share"]
    full = np.arange(24.0).reshape(4, 6)
    m = rank % 2
    np.testing.assert_array_equal(share, full[2 * m:2 * m + 2])
    np.testing.assert_array_equal(both, full[rank:rank + 1])
    for got in (full1, full2, full3):
        np.testing.assert_array_equal(got, full)


def test_a_failing_rank_fails_the_world_at_once():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_world(ranks.failing_rank, 2, backend="gloo", devices="cpu",
                  timeout_s=60)
    assert time.monotonic() - t0 < 25


def test_a_hanging_rank_fails_the_world_at_its_limit():
    with pytest.raises(TimeoutError, match="did not finish"):
        run_world(ranks.hanging_rank, 2, backend="gloo", devices="cpu",
                  timeout_s=8)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        run_world(ranks.hanging_rank, 2, backend="gloo",
                  devices=["cpu"], timeout_s=5)
    from repro_torch.launch.mesh import init_world
    with pytest.raises(ValueError, match="backend"):
        init_world(0, 1, port=1, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        init_world(0, 1, port=1, backend="nccl", device="cpu")
