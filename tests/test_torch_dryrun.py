"""The port's dry run against the JAX package's shapes and shardings.

``models.steps``' ``train_specs`` / ``prefill_specs`` / ``serve_specs``
build meta tensors with the shapes and dtypes of the reference's
``ShapeDtypeStruct``\\ s, leaf by leaf (the reference's stacked layers
carried to the port's names by its conversion, as in
``tests/test_torch_sharding.py``; Adam's moments keyed by the params'
dotted names).  ``launch.dryrun``'s bytes, global and on one device,
equal to the byte those computed from the reference's own shardings:
``NamedSharding(AbstractMesh, spec).shard_shape`` of every leaf the
reference's ``launch/dryrun.py`` passes as ``in_shardings``, with its
config overrides written out here (the reference's module forces 512
host devices when imported, so it is not imported).
"""
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs.shapes import SHAPES as JSHAPES
from repro.kge import make_model as jmake_model
from repro.kge.train import TrainConfig as JTrainConfig
from repro.models import ARCH_IDS, build as jbuild, get_config as jget
from repro.models import sharding as jsh
from repro.models import steps as jsteps
from repro.optim import OPTIMIZERS as JOPT
from repro_torch.launch import dryrun
from repro_torch.models import build, get_config
from repro_torch.models import sharding as tsh
from repro_torch.models import steps
from test_torch_sharding import _is_info, port_leaves, ref_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

AMESH = {"single": AbstractMesh((16, 16), ("data", "model")),
         "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _infos(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), np.dtype(x.dtype).name,
                                   (None,) * x.ndim), tree)


def _port(tree):
    return port_leaves(tree, tsh._map(lambda _, x: (None,) * x.dim(), tree))


def _flat(tree):
    return sorted(_port(tree).values(), key=repr)


def _ref_flat(tree):
    return sorted(jax.tree.leaves(_infos(tree), is_leaf=_is_info), key=repr)


SPEC_CASES = [("h2o_danube_1_8b", True), ("olmoe_1b_7b", True),
              ("falcon_mamba_7b", True), ("recurrentgemma_2b", True),
              ("whisper_base", True), ("llava_next_34b", True),
              ("h2o_danube_1_8b", False)]


@pytest.mark.parametrize("arch,reduced", SPEC_CASES)
def test_specs_match_the_references(arch, reduced):
    """Params, Adam's count and moments, the batch; prefill's params and
    batch; serve's params, cache, token and position."""
    jm, m = jbuild(jget(arch, reduced)), build(get_config(arch, reduced))
    b, s = 4, 64
    jp, jo, jb = jsteps.train_specs(jm, b, s)
    p, o, bt = steps.train_specs(m, b, s)
    want = ref_leaves(_infos(jp), p)
    assert _port(p) == want
    assert {k: v[:2] for k, v in ref_leaves(_infos(jo.mu), p).items()} == \
        {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
         for k, t in o.mu.items()} == \
        {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
         for k, t in o.nu.items()}
    assert (tuple(o.step.shape), str(o.step.dtype)) == \
        (tuple(jo.step.shape), "torch." + np.dtype(jo.step.dtype).name)
    assert list(bt) == list(jb) and _port(bt) == {
        k: (tuple(v.shape), np.dtype(v.dtype).name, (None,) * v.ndim)
        for k, v in jb.items()}
    jp2, jb2 = jsteps.prefill_specs(jm, b, s)
    p2, b2 = steps.prefill_specs(m, b, s)
    assert _port(p2) == ref_leaves(_infos(jp2), p2)
    assert _flat(b2) == _ref_flat(jb2)
    jp3, jc, jt, jpos = jsteps.serve_specs(jm, b, s)
    p3, c, t, pos = steps.serve_specs(m, b, s)
    assert _port(p3) == ref_leaves(_infos(jp3), p3)
    assert _flat(c) == _ref_flat(jc)
    for x, jx in ((t, jt), (pos, jpos)):
        assert tuple(x.shape) == tuple(jx.shape)
        assert str(x.dtype) == "torch." + np.dtype(jx.dtype).name
    assert p["embed"].device.type == "meta"


def _ref_cfg(arch, shape, multi):
    """``repro.launch.dryrun.dryrun_one``'s overrides."""
    cfg = jget(arch).with_(kv_groups=16, moe_dp_blocks=32 if multi else 16,
                           moe_impl="shard_map")
    if cfg.moe is not None and cfg.moe.n_experts % 16:
        cfg = cfg.with_(moe_ff_split=16 // math.gcd(cfg.moe.n_experts, 16))
    if cfg.d_model <= 2560 and JSHAPES[shape].step == "train":
        cfg = cfg.with_(remat="none")
    return cfg


def _bytes(tree, shardings):
    g = d = 0
    for x, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda v: isinstance(v, NamedSharding))):
        item = np.dtype(x.dtype).itemsize
        g += math.prod(x.shape) * item
        d += math.prod(sh.shard_shape(x.shape)) * item
    return {"global": g, "per_device": d}


def _ref_bytes(arch, shape, mesh):
    """The bytes of the reference's ``in_shardings`` for one tag."""
    am = AMESH[mesh]
    cfg = _ref_cfg(arch, shape, mesh == "multi")
    model, sh = jbuild(cfg), JSHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    rep = NamedSharding(am, P())
    if sh.step == "train":
        params, opt, batch = jsteps.train_specs(model, b, s)
        p_sh = jsh.param_shardings(cfg, am, params)
        return {"params": _bytes(params, p_sh),
                "opt_count": _bytes(opt.step, rep),
                "opt_mu": _bytes(opt.mu, jsh.param_shardings(cfg, am, opt.mu)),
                "opt_nu": _bytes(opt.nu, jsh.param_shardings(cfg, am, opt.nu)),
                "batch": _bytes(batch, jsh.batch_shardings(am, b, batch))}
    params, cache, token, pos = jsteps.serve_specs(model, b, s)
    return {"params": _bytes(params, jsh.param_shardings(cfg, am, params)),
            "cache": _bytes(cache, jsh.cache_shardings(cfg, am, b, cache)),
            "token": _bytes(token, NamedSharding(
                am, jsh.batch_pspec(am, b, 2))),
            "pos": _bytes(pos, rep)}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_bytes_match_the_reference_shardings(arch, shape, mesh):
    rec = dryrun.dryrun_one(arch, shape, mesh == "multi")
    assert rec["status"] == "ok"
    want = _ref_bytes(arch, shape, mesh)
    got = {k: v for k, v in rec["bytes"].items() if k != "total"}
    assert got == want
    assert rec["bytes"]["total"]["per_device"] == sum(
        v["per_device"] for v in want.values())
    assert rec["n_devices"] == (512 if mesh == "multi" else 256)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_kge_dryrun_bytes_match_the_reference_shardings(mesh):
    """``--kge go``: TransE at GO size, batch 8,192, Adam."""
    from repro.configs.go_kge import CONFIG as GO
    am = AMESH[mesh]
    model = jmake_model("transe", GO.n_terms, 3, dim=GO.dim)
    tc = JTrainConfig(batch_size=8192, num_negs=32)
    params = jax.eval_shape(model.init, jax.random.key(0))
    opt = jax.eval_shape(JOPT[tc.optimizer](tc.lr).init, params)
    p_sh = {k: NamedSharding(am, v) for k, v in model.param_shardings(
        "model", axis_size=am.shape["model"]).items()}
    dp = ("pod", "data") if mesh == "multi" else ("data",)
    triples = jax.ShapeDtypeStruct((tc.batch_size, 3), np.int32)
    want = {"params": _bytes(params, p_sh),
            "opt_count": _bytes(opt.step, NamedSharding(am, P())),
            "opt_mu": _bytes(opt.mu, p_sh), "opt_nu": _bytes(opt.nu, p_sh),
            "triples": _bytes(triples, NamedSharding(am, P(dp, None)))}
    rec = dryrun.dryrun_kge("go", mesh == "multi")
    assert {k: v for k, v in rec["bytes"].items() if k != "total"} == want


def test_main_writes_one_json_a_tag(tmp_path, capsys):
    """``--all --mesh both``: a record for every tag, the full-attention
    archs' long_500k skipped as the reference skips them; ``--kge go``."""
    assert dryrun.main(["--all", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    assert dryrun.main(["--kge", "go", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(ARCH_IDS) * len(JSHAPES) * 2 + 2
    skipped = {r["tag"] for r in recs if r["status"] == "skipped"}
    long_ok = {"h2o_danube_1_8b", "falcon_mamba_7b", "recurrentgemma_2b"}
    assert skipped == {f"{a}__long_500k__{m}" for a in ARCH_IDS
                       if a not in long_ok for m in ("single", "multi")}
    for r in recs:
        if r["status"] == "ok":
            tot = r["bytes"]["total"]
            assert 0 < tot["per_device"] <= tot["global"]
            assert not {"xla_cost", "memory", "roofline"} & set(r)
    assert "FAIL" not in capsys.readouterr().out


def _nbytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("run", ["zoo", "zoo_deep"])
@pytest.mark.parametrize("arch", [a for a, _, _ in chip_smoke.ZOO_ARCHS])
def test_zoo_depths_serve_specs_match_the_reference(arch, run):
    """chip_smoke's zoo archs at each run's depth, full width: the port's
    ``serve_specs`` bytes on the meta device (params; the cache at B 2
    and the generation's 2,064 positions) equal the reference's
    ``steps.serve_specs`` under ``jax.eval_shape`` for the same cut
    config, and fit the phase's budget."""
    depth = {a: (d, deep) for a, d, deep in chip_smoke.ZOO_ARCHS}[arch]
    n_layers = depth[run == "zoo_deep"]
    B = chip_smoke.ZOO_BATCH
    seq = chip_smoke.ZOO_PROMPT + chip_smoke.ZOO_STEPS
    jp, jc, _, _ = jsteps.serve_specs(
        jbuild(jget(arch).with_(n_layers=n_layers)), B, seq)
    want = {"params": _nbytes(jp), "cache": _nbytes(jc)}
    assert chip_smoke.serve_bytes(arch, n_layers, B, seq) == want
    assert want["params"] + want["cache"] <= chip_smoke.ZOO_BUDGET_BYTES
