"""The port's sharding rules against the JAX package's, leaf by leaf.

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices)
over the trees ``jax.eval_shape`` gives at full config; the port's on a
``MeshShape`` over its meta-tensor trees.  The reference stacks a group
of layers on a leading axis where the port keeps one entry a layer, so
each reference leaf is carried to the port's names by the port's own
conversion (``models.convert._layer_leaves``: layer i of a stack, and the
hybrid's periods and remainder): its spec without the stacked entry,
which must be None, is the port's spec of that layer's leaf.  A spec
compares as a tuple with a one-name tuple entry read as the name (the
reference's ``PartitionSpec`` normalizes it so).

Cases: ``param_pspec`` for every arch at model-axis sizes 16 and 8, and
grok with its ff split; ``batch_pspec`` and ``cache_shardings`` on the
single and multi-pod meshes; the six KGE models' ``param_shardings`` at
GO size; ``shard_shape`` against ``NamedSharding.shard_shape``.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import kge as jkge
from repro.configs.go_kge import CONFIG as GO
from repro.models import ARCH_IDS, build as jbuild, get_config as jget
from repro.models import sharding as jsh
from repro_torch import kge as tkge
from repro_torch.launch.mesh import (MeshShape, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build, get_config
from repro_torch.models import sharding as tsh
from repro_torch.models.convert import _flatten, _layer_leaves

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def jmesh(sizes, names):
    return AbstractMesh(tuple(sizes), tuple(names))


def norm_spec(spec, ndim=None):
    """A spec as a tuple of names / name tuples / None, one-name tuples
    read as the name, padded with None to ``ndim``."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    if ndim is not None:
        out += [None] * (ndim - len(out))
    return tuple(out)


def _is_info(x):
    """A ``(shape, dtype name, spec)`` leaf of a reference tree."""
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[1], str)


def _stacked(info):
    """An object array of a stacked leaf's layers, for ``_layer_leaves``."""
    shape, dtype, spec = info
    assert spec[0] is None, f"a rule shards the stacked axis: {spec}"
    arr = np.empty(shape[0], dtype=object)
    for i in range(shape[0]):
        arr[i] = (shape[1:], dtype, spec[1:])
    return arr


def ref_leaves(ref_tree, port_tree):
    """``{port dotted name: (shape, dtype, spec)}`` of a reference tree of
    ``(shape, dtype, spec)`` leaves, carried by the port's conversion."""
    out = {}
    for top, group in ref_tree.items():
        want = port_tree[top]
        if not isinstance(want, list):
            for p, v in _flatten({top: group}).items():
                out[p] = v
            continue
        if isinstance(group, dict) and "periods" in group:
            g = {"periods": jax.tree.map(_stacked, group["periods"],
                                         is_leaf=_is_info)}
            g.update({k: v for k, v in group.items() if k != "periods"})
        else:
            g = jax.tree.map(_stacked, group, is_leaf=_is_info)
        for i, layer in enumerate(_layer_leaves(top, g, len(want))):
            for p, v in layer.items():
                out[f"{top}.{i}.{p}"] = v
    return out


def walk(x, spec, path=()):
    """``[(path, tensor, spec)]`` of a port tree of tensors and its tree
    of specs, walked in parallel."""
    if isinstance(x, dict):
        return [t for k in x for t in walk(x[k], spec[k], path + (k,))]
    if isinstance(x, (list, tuple)):
        return [t for i, (a, b) in enumerate(zip(x, spec))
                for t in walk(a, b, path + (str(i),))]
    return [(path, x, spec)]


def port_leaves(port_tree, specs):
    return {".".join(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""),
                          norm_spec(s))
            for p, x, s in walk(port_tree, specs)}


@functools.lru_cache(maxsize=None)
def ref_params(arch, ff_split=0):
    cfg = jget(arch)
    if ff_split:
        cfg = cfg.with_(moe_ff_split=ff_split)
    return cfg, jax.eval_shape(jbuild(cfg).init, jax.random.key(0))


def _with_infos(tree, specs):
    return jax.tree.map(lambda x, s: (tuple(x.shape),
                                      np.dtype(x.dtype).name,
                                      norm_spec(s.spec, x.ndim)),
                        tree, specs)


PARAM_CASES = [(a, m, 0) for a in ARCH_IDS for m in (16, 8)] + \
    [("grok_1_314b", 16, 2), ("grok_1_314b", 8, 2)]


@pytest.mark.parametrize("arch,model_axis,ff_split", PARAM_CASES)
def test_param_pspec_matches_the_reference(arch, model_axis, ff_split):
    jcfg, tree = ref_params(arch, ff_split)
    jspecs = jsh.param_shardings(jcfg, jmesh((2, model_axis),
                                             ("data", "model")), tree)
    want = ref_leaves(_with_infos(tree, jspecs), build(get_config(arch))
                      .param_tree(None))
    cfg = get_config(arch)
    if ff_split:
        cfg = cfg.with_(moe_ff_split=ff_split)
    params = build(cfg).param_tree(None)
    got = port_leaves(params, tsh.param_shardings(
        cfg, make_host_mesh(2, model_axis), params))
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]
    assert any("model" in v[2] for v in got.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 7, 16, 32, 128, 256, 512, 1000])
def test_batch_pspec_matches_the_reference(mesh, batch):
    sizes, names = MESHES[mesh]
    for ndim in (1, 2, 3):
        got = tsh.batch_pspec(MeshShape(names, sizes), batch, ndim)
        want = jsh.batch_pspec(jmesh(sizes, names), batch, ndim)
        assert norm_spec(got) == norm_spec(want, ndim)
        assert len(got) == ndim


def _dryrun_cfgs(arch, multi):
    """The dry run's config overrides, written out for each package."""
    out = []
    for get in (jget, get_config):
        cfg = get(arch).with_(kv_groups=16, moe_dp_blocks=32 if multi else 16,
                              moe_impl="shard_map")
        if cfg.moe is not None and cfg.moe.n_experts % 16:
            cfg = cfg.with_(moe_ff_split=2)
        out.append(cfg)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_the_reference(arch, mesh):
    """At decode_32k's batch 128 and long_500k's batch 1, seq 32,768, with
    the dry run's 16 KV slots, and at the config's own slots."""
    sizes, names = MESHES[mesh]
    jcfg, cfg = _dryrun_cfgs(arch, mesh == "multi")
    for (jc, c) in ((jcfg, cfg), (jget(arch), get_config(arch))):
        for batch in (128, 1):
            jtree = jbuild(jc).cache_spec(batch, 32_768)
            jspecs = jsh.cache_shardings(jc, jmesh(sizes, names), batch,
                                         jtree)
            want = sorted(jax.tree.leaves(_with_infos(jtree, jspecs),
                                          is_leaf=_is_info), key=repr)
            tree = build(c).cache_spec(batch, 32_768)
            specs = tsh.cache_shardings(c, MeshShape(names, sizes), batch,
                                        tree)
            got = sorted(port_leaves(tree, specs).values(), key=repr)
            assert got == want


@pytest.mark.parametrize("axis", [16, 7, None])
@pytest.mark.parametrize("name", sorted(jkge.available_models()))
def test_kge_param_shardings_match_the_reference(name, axis):
    """GO size (the workload's 40,000 terms, 3 relations, dim 200): the
    entity-rowed tables shard over "model", the 3-row relation tables are
    replicated on a 16-way axis."""
    want = jkge.make_model(name, GO.n_terms, 3, dim=GO.dim).param_shardings(
        "model", axis_size=axis)
    got = tkge.make_model(name, GO.n_terms, 3, dim=GO.dim).param_shardings(
        "model", axis_size=axis)
    assert set(got) == set(want)
    for k in got:
        assert norm_spec(got[k]) == norm_spec(want[k], len(got[k])), k


@pytest.mark.parametrize("shape,spec", [
    ((256, 4096), (("pod", "data"), None)), ((64, 7, 32), (None, None,
                                                           "model")),
    ((32, 16), ("data", "model")), ((), ()), ((48,), (None,)),
    ((51_865, 512), ("model", None)), ((512, 3), (("data", "model"),
                                                  None))])
def test_shard_shape_matches_named_sharding(shape, spec):
    mesh = make_production_mesh(multi_pod=True)
    jm = jmesh((2, 16, 16), ("pod", "data", "model"))
    try:
        want = NamedSharding(jm, P(*spec)).shard_shape(shape)
    except ValueError:
        with pytest.raises(ValueError, match="does not divide"):
            tsh.shard_shape(shape, spec, mesh)
        return
    assert tsh.shard_shape(shape, spec, mesh) == tuple(want)
