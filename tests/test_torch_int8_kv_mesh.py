"""The int8 KV cache under a model axis, on the CPU (gloo): ``DenseLM``
with ``kv_cache_dtype="int8"`` on the reference's tensor-parallel layout,
each rank quantizing and dequantizing its own ``G / n`` KV slots.

Reduced h2o-danube-1.8b (sliding window: a prompt of 80 past its window
of 64) and reduced qwen2-72b (full attention, QKV bias), fp32, B 3, on
the reference's init carried across by ``convert``, ``kv_groups`` raised
to the model axis (``sharding.tp_config``).  The port runs them in gloo
worlds of 2 and 4 ranks, meshes (1, 2) and (1, 4): the prefill step, then
3 ``decode_step``s, each on the rank's slot block of the reference's own
int8 cache before that step and its greedy token (so every step starts
from the same cache on both sides).  The reference runs them single-device
in this process and once, in one subprocess with 4 forced host devices,
as its own tensor-parallel path: the steps jitted with
``param_shardings`` / ``batch_shardings`` / ``cache_shardings`` on an
Auto (1, 4) ``Mesh`` built with the constructor (ROADMAP Queue 3 item
6), its decode steps fed the same caches and tokens.

Held, block by block, by ``tests/test_torch_int8_kv.py``'s rules: logits
within 1e-5 and the same argmax; a rank's ``k_scale`` / ``v_scale`` the
reference's slot block within 1e-5 relative; its int8 ``k`` / ``v`` the
reference's block, equal except entries whose quotient lies within 1e-3
of a rounding boundary (counted, printed with -s, at most 1 apart; the
prefill's boundaries read from the reference's fp cache, a decode step's
new slot from the port's unquantized k and v); after a decode step every
slot but the new one left bit for bit; a rank's param and cache bytes
equal to ``sharding.device_bytes`` on a ``MeshShape`` of the same sizes,
``cache_spec`` under the mesh the rank's shapes.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro_torch.launch.mesh import MeshShape, run_world
from repro_torch.models import build, get_config
from repro_torch.models.sharding import (cache_shardings, device_bytes,
                                         param_shardings, tp_config)

import _torch_mesh_ranks as ranks
from test_torch_int8_kv import LOGIT_TOL, SCALE_RTOL, _check_int8

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("h2o_danube_1_8b", "qwen2_72b")
WORLDS = (2, 4)
B, S, STEPS = 3, 80, 3

SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import build, get_config, runtime
    from repro.models.sharding import (batch_pspec, batch_shardings,
                                       cache_shardings, param_shardings)

    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
    out = {}
    for arch, kw, tree, batch, pos0, fed in cases:
        cfg = get_config(arch, reduced=True).with_(
            dtype="float32", kv_cache_dtype="int8", **kw)
        model = build(cfg)
        params = jax.tree.map(jnp.asarray, tree)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        n, cache_len = batch["tokens"].shape[0], pos0 + len(fed)
        with mesh, runtime.use_mesh(mesh):
            p_sh = param_shardings(cfg, mesh, params)
            c_sh = cache_shardings(cfg, mesh, n,
                                   model.cache_spec(n, cache_len))
            t_sh = NamedSharding(mesh, batch_pspec(mesh, n, 2))
            prefill = jax.jit(
                lambda p, x: model.prefill(p, x, cache_len=cache_len),
                in_shardings=(p_sh, batch_shardings(mesh, n, b)),
                out_shardings=(None, c_sh))
            decode = jax.jit(
                model.decode_step,
                in_shardings=(p_sh, c_sh, t_sh, NamedSharding(mesh, P())),
                out_shardings=(None, c_sh))
            logits, cache = prefill(params, b)
            out[f"{arch}/prefill"] = np.asarray(logits)
            for k, v in cache.items():
                out[f"{arch}/cache_prefill/{k}"] = np.asarray(v)
            for i, (tok, before) in enumerate(fed):
                logits, cache = decode(
                    params, {k: jnp.asarray(v) for k, v in before.items()},
                    jnp.asarray(tok), jnp.asarray(pos0 + i, jnp.int32))
                out[f"{arch}/decode/{i}"] = np.asarray(logits)
                for k, v in cache.items():
                    out[f"{arch}/cache/{i}/{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _kw(arch, n):
    return {"kv_groups": tp_config(get_config(arch, reduced=True),
                                   n).kv_groups}


def _jm(arch, n, quant="int8"):
    return jbuild(jget_config(arch, reduced=True).with_(
        dtype="float32", kv_cache_dtype=quant, **_kw(arch, n)))


def _reference(arch, n, tree, toks):
    """The reference single-device, int8: the prefill's logits and cache,
    its fp path's cache (where each quotient lies), then STEPS greedy
    steps on its own cache: each step's token, the cache before it, its
    logits and the cache after it."""
    params = jax.tree.map(jnp.asarray, tree)
    b = {"tokens": jnp.asarray(toks)}
    jm = _jm(arch, n)
    logits, cache = jm.prefill(params, b, cache_len=S + STEPS)
    _, fp = _jm(arch, n, "model").prefill(params, b, cache_len=S + STEPS)
    out = {"prefill": np.asarray(logits),
           "cache_prefill": jax.tree.map(np.asarray, cache),
           "fp": jax.tree.map(np.asarray, fp), "fed": [], "decode": [],
           "cache": []}
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for i in range(STEPS):
        out["fed"].append((tok, jax.tree.map(np.asarray, cache)))
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.asarray(S + i, jnp.int32))
        out["decode"].append(np.asarray(logits))
        out["cache"].append(jax.tree.map(np.asarray, cache))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference single-device first (its caches feed the decode
    steps), then the reference's TP subprocess and the port's worlds of 2
    and 4 ranks at once."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("int8_mesh")
    rng = np.random.default_rng(13)
    trees, toks, single, cases = {}, {}, {}, {n: [] for n in WORLDS}
    for i, arch in enumerate(ARCHS):
        trees[arch] = jax.tree.map(np.asarray,
                                   _jm(arch, 4).init(jax.random.key(20 + i)))
        toks[arch] = rng.integers(0, get_config(arch, reduced=True).vocab,
                                  (B, S)).astype(np.int32)
        for n in WORLDS:
            single[(n, arch)] = _reference(arch, n, trees[arch], toks[arch])
            cases[n].append((arch, _kw(arch, n), trees[arch],
                             {"tokens": toks[arch]}, S,
                             single[(n, arch)]["fed"]))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases[4], f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "cases.pkl"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            worlds = {n: pool.submit(
                run_world, ranks.int8_rank, n, backend="gloo",
                devices="cpu", timeout_s=240, args=(n, cases[n]))
                for n in WORLDS}
            port = {n: w.result() for n, w in worlds.items()}
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    ref_tp = {}
    for arch in ARCHS:
        pre = f"{arch}/cache_prefill/"
        ref_tp[arch] = {
            "prefill": ref[f"{arch}/prefill"],
            "cache_prefill": {k[len(pre):]: v for k, v in ref.items()
                              if k.startswith(pre)},
            "decode": [ref[f"{arch}/decode/{i}"] for i in range(STEPS)],
            "cache": [{k[len(f"{arch}/cache/{i}/"):]: v
                       for k, v in ref.items()
                       if k.startswith(f"{arch}/cache/{i}/")}
                      for i in range(STEPS)]}
    return {"port": port, "single": single, "ref_tp": ref_tp,
            "trees": trees}


CASES = [(n, a, "single") for n in WORLDS for a in ARCHS] + \
    [(4, a, "ref_tp") for a in ARCHS]
IDS = [f"{n}-{a}-{w}" for n, a, w in CASES]


def _want(runs, n, arch, against):
    """The reference's results, and its fp cache (from the single-device
    run at the same config: the prefill's boundaries)."""
    single = runs["single"][(n, arch)]
    return (single if against == "single" else runs["ref_tp"][arch],
            single["fp"])


def _block(x, rank, n):
    """The rank's slot block (axis 2) of a cache leaf."""
    G = x.shape[2]
    return x[:, :, rank * G // n:(rank + 1) * G // n]


@pytest.mark.parametrize("n,arch,against", CASES, ids=IDS)
def test_int8_prefill_logits_match(runs, n, arch, against):
    want, _ = _want(runs, n, arch, against)
    for got in runs["port"][n]:                   # every rank's
        rec = got[arch]
        assert rec["prefill"].shape == want["prefill"].shape
        np.testing.assert_allclose(rec["prefill"], want["prefill"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert np.array_equal(rec["prefill"].argmax(-1),
                              want["prefill"].argmax(-1))


@pytest.mark.parametrize("n,arch,against", CASES, ids=IDS)
def test_each_ranks_int8_cache_is_its_block(runs, n, arch, against):
    """After the prefill: the rank's int8 values and scales, slot block by
    slot block, against the reference's."""
    want, fp = _want(runs, n, arch, against)
    jc = want["cache_prefill"]
    for rank, got in enumerate(runs["port"][n]):
        tc = got[arch]["cache_prefill"]
        assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale"}
        assert tc["k"].dtype == np.int8 and tc["k_scale"].dtype == np.float32
        for name in ("k", "v"):
            assert tc[name].shape == _block(jc[name], rank, n).shape
            _check_int8(tc[name], tc[f"{name}_scale"],
                        _block(jc[name], rank, n),
                        _block(jc[f"{name}_scale"], rank, n),
                        _block(fp[name], rank, n),
                        f"{n}-{arch}-{against} rank {rank} {name}")


@pytest.mark.parametrize("n,arch,against", CASES, ids=IDS)
def test_int8_decode_on_the_references_cache_matches(runs, n, arch,
                                                     against):
    """Each step from the reference's own cache: the logits, every slot
    but the new one left as it was, the new slot quantized as the
    reference quantizes it (its boundaries from the port's unquantized k
    and v, within ~1e-6 of the reference's)."""
    want, _ = _want(runs, n, arch, against)
    fed = runs["single"][(n, arch)]["fed"]
    for rank, got in enumerate(runs["port"][n]):
        steps = got[arch]["decode"]
        assert len(steps) == STEPS
        for i, st in enumerate(steps):
            pos = S + i
            np.testing.assert_allclose(st["logits"], want["decode"][i],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=str(pos))
            assert np.array_equal(st["logits"].argmax(-1),
                                  want["decode"][i].argmax(-1))
            before, after = fed[i][1], want["cache"][i]
            Sc = before["k"].shape[3]
            others = np.ones(Sc, bool)
            others[pos % Sc] = False
            for name in ("k", "v"):
                for part in (name, f"{name}_scale"):
                    assert np.array_equal(
                        st["cache"][part][:, :, :, others],
                        _block(before[part], rank, n)[:, :, :, others]), part
                slot = pos % Sc
                _check_int8(st["cache"][name][:, :, :, slot],
                            st["cache"][f"{name}_scale"][:, :, :, slot],
                            _block(after[name], rank, n)[:, :, :, slot],
                            _block(after[f"{name}_scale"], rank,
                                   n)[:, :, :, slot],
                            st["fp"][name],
                            f"{n}-{arch}-{against} rank {rank} {name} "
                            f"pos {pos}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_int8_bytes_are_the_dry_runs(runs, n, arch):
    """Each rank's params and int8 cache (values and scales) hold
    ``device_bytes``' per-device bytes of the reference's rules on a
    MeshShape (1, n): the cache a 1 / n share, the scales cut with the
    slots; ``cache_spec`` under the mesh the rank's shapes."""
    cfg = get_config(arch, reduced=True).with_(
        dtype="float32", kv_cache_dtype="int8", **_kw(arch, n))
    model = build(cfg)
    shape = MeshShape(("data", "model"), (1, n))
    params = model.param_tree(None)
    _, d_par = device_bytes(params, param_shardings(cfg, shape, params),
                            shape)
    cache = model.cache_spec(B, S + STEPS)
    specs = cache_shardings(cfg, shape, B, cache)
    assert specs["k_scale"][2] == specs["k"][2] == "model"
    g_cache, d_cache = device_bytes(cache, specs, shape)
    assert d_cache * n == g_cache
    for got in runs["port"][n]:
        rec = got[arch]
        assert rec["param_bytes"] == d_par
        assert rec["cache_bytes"] == d_cache
        assert rec["cache_spec"] == {k: v.shape for k, v in
                                     rec["cache_prefill"].items()}
