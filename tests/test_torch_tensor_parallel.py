"""The reference's tensor-parallel layout on a process mesh, on the CPU
(gloo): ``convert.shard_params`` cuts every leaf of the dense, VLM and
MoE families by ``sharding.param_pspec`` and the serving path runs on
the rank's heads, channels and vocab block.

Reduced h2o-danube-1.8b (S 96 past W 64), qwen2-72b (QKV bias),
mistral-large-123b, olmoe-1b-7b (``moe_impl="shard_map"``) and
llava-next-34b (16 image embeddings before the prompt), fp32, B 3, on the
reference's init (``model.init(jax.random.key(i))``), ``kv_groups``
raised to the model axis (``sharding.tp_config``: 4 KV slots over 2 kv
heads on 4 ranks, where a rank's slot reads head columns another rank
holds).  The port runs them in gloo worlds of 2 and 4 ranks, meshes (1,
2) and (1, 4): the prefill step, 3 greedy ``decode_step``s (each fed the
last argmax) and the serve step's tokens.  The reference runs them
single-device in this process, and once, in one subprocess with 4 forced
host devices, as its own tensor-parallel path: the prefill and decode
steps jitted with ``param_shardings``, ``batch_shardings`` and
``cache_shardings`` on an Auto (1, 4) ``Mesh`` built with the
constructor (``jax.make_mesh``'s Explicit axes break the reference,
ROADMAP Queue 3 item 6), as ``src/repro/launch/dryrun.py:127-162``
builds them.

Held (``tests/test_torch_lm.py``'s tolerances): prefill and decode logits
within 2e-4 (rtol and atol), the same greedy tokens (the serve step's
too), each rank's cache within 1e-5 of its slots of the reference's
cache, after the prefill and after the decode steps;
``convert.gather_params`` equal to the full params; a rank's param and
cache bytes equal to ``sharding.device_bytes`` of ``param_shardings`` and
``cache_shardings`` on a ``MeshShape`` of the same sizes.  Training on
the cut weights: reduced h2o-danube on (1, 4) (the K / V gather's
backward) and llava-next-34b on (2, 2) (the VLM's loss over the data
axes), ``loss_and_grads`` against ``jax.value_and_grad`` single-device:
the loss within 1e-5 relative, every gathered leaf within 2e-4 *
max|g|.  Reduced qwen2-72b, B 4, on (2, 2): the steps take and give the
global batch's rows, each rank's cache its rows and slots.
``cache_spec`` under the mesh gives the rank's shapes.  A config a model
axis cannot cut raises ``ValueError``, params not cut raise on the mesh
and the int8 KV cache runs there.
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
import torch

from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro_torch.launch.mesh import MeshShape, run_world
from repro_torch.models import build, get_config
from repro_torch.models.convert import shard_params
from repro_torch.models.sharding import (cache_shardings, device_bytes,
                                         param_shardings, tp_config)

import _torch_mesh_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-4
CACHE_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
B, STEPS = 3, 3
ARCHS = ("h2o_danube_1_8b", "qwen2_72b", "mistral_large_123b",
         "olmoe_1b_7b", "llava_next_34b")
PROMPT = {"h2o_danube_1_8b": 96}          # the others 24
WORLDS = (2, 4)
TRAIN = (((1, 4), "h2o_danube_1_8b"), ((2, 2), "llava_next_34b"))
DATA_SERVE, DATA_B = "qwen2_72b", 4      # on (2, 2): 2 rows a data rank

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
    for arch, kw, tree, batch, pos0, steps in cases:
        cfg = get_config(arch, reduced=True).with_(dtype="float32", **kw)
        model = build(cfg)
        params = jax.tree.map(jnp.asarray, tree)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        n, cache_len = batch["tokens"].shape[0], pos0 + steps
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
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            for i in range(steps):
                logits, cache = decode(params, cache, tok,
                                       jnp.asarray(pos0 + i, jnp.int32))
                out[f"{arch}/decode/{i}"] = np.asarray(logits)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
            for k, v in cache.items():
                out[f"{arch}/cache/{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _kw(arch, n):
    kw = {"moe_impl": "shard_map"} if arch == "olmoe_1b_7b" else {}
    cfg = tp_config(get_config(arch, reduced=True).with_(**kw), n)
    return dict(kw, kv_groups=cfg.kv_groups)


def _unstack(tree):
    """The reference's stacked params as the port's dotted names."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(k.key for k in path)
        if name.startswith("layers."):
            for i in range(a.shape[0]):
                out[f"layers.{i}.{name[len('layers.'):]}"] = a[i]
        else:
            out[name] = a
    return out


def _batch(cfg, rng, n, S, labels=False):
    batch = {"tokens": rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)
        batch["labels"][rng.random((n, S)) < 0.1] = -1
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (n, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    return batch


def _reference(jm, tree, batch, pos0):
    """The reference single-device: prefill logits and cache, then STEPS
    greedy decode steps' logits and the cache after them."""
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache = jm.prefill(params, b, cache_len=pos0 + STEPS)
    out = {"prefill": np.asarray(logits),
           "cache_prefill": {k: np.asarray(v) for k, v in cache.items()},
           "decode": []}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(STEPS):
        logits, cache = jm.decode_step(params, cache, tok,
                                       jnp.asarray(pos0 + i, jnp.int32))
        out["decode"].append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out["cache"] = {k: np.asarray(v) for k, v in cache.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's TP subprocess and the port's worlds of 2 and 4
    ranks, at once; meanwhile the reference single-device in this
    process."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(7)
    serving = {n: [] for n in WORLDS}
    trees = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jget_config(arch, reduced=True).with_(dtype="float32",
                                                     **_kw(arch, 4))
        trees[arch] = jax.tree.map(np.asarray,
                                   jbuild(jcfg).init(jax.random.key(i)))
        batch = _batch(jcfg, rng, B, PROMPT.get(arch, 24))
        pos0 = batch["tokens"].shape[1] + jcfg.n_frontend_tokens
        for n in WORLDS:
            serving[n].append((arch, _kw(arch, n), trees[arch], batch, pos0,
                               STEPS))
    data_serving = [(DATA_SERVE, _kw(DATA_SERVE, 2), trees[DATA_SERVE],
                     _batch(get_config(DATA_SERVE, reduced=True), rng,
                            DATA_B, 24), 24, STEPS)]
    training = [(sizes, arch, _kw(arch, sizes[1]), trees[arch],
                 _batch(get_config(arch, reduced=True), rng, 2, 32,
                        labels=True)) for sizes, arch in TRAIN]
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(serving[4], f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "cases.pkl"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            worlds = {n: pool.submit(
                run_world, ranks.tp_rank, n, backend="gloo", devices="cpu",
                timeout_s=240, args=(n, serving[n],
                                     training if n == 4 else [],
                                     data_serving if n == 4 else ()))
                for n in WORLDS}

            def jm(arch, n):
                return jbuild(jget_config(arch, reduced=True).with_(
                    dtype="float32", **_kw(arch, n)))
            single = {(n, c[0]): _reference(jm(c[0], n), c[2], c[3], c[4])
                      for n in WORLDS for c in serving[n]}
            c = data_serving[0]
            single["data"] = _reference(jm(c[0], 2), c[2], c[3], c[4])
            train_want = {}
            for sizes, arch, _, tree, batch in training:
                model = jm(arch, sizes[1])
                (loss, _), g = jax.value_and_grad(
                    lambda p: model.loss(p, jax.tree.map(jnp.asarray, batch)),
                    has_aux=True)(jax.tree.map(jnp.asarray, tree))
                train_want[(sizes, arch)] = {
                    "loss": float(loss),
                    "grads": _unstack(jax.tree.map(np.asarray, g))}
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
        ref_tp[arch] = {
            "prefill": ref[f"{arch}/prefill"],
            "decode": [ref[f"{arch}/decode/{i}"] for i in range(STEPS)],
            **{part: {k[len(f"{arch}/{part}/"):]: v for k, v in ref.items()
                      if k.startswith(f"{arch}/{part}/")}
               for part in ("cache_prefill", "cache")}}
    return {"port": port, "single": single, "ref_tp": ref_tp,
            "trees": trees, "serving": serving, "train_want": train_want}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _want(runs, n, arch, against):
    return runs["single"][(n, arch)] if against == "single" \
        else runs["ref_tp"][arch]


CASES = [(n, a, "single") for n in WORLDS for a in ARCHS] + \
    [(4, a, "ref_tp") for a in ARCHS]
IDS = [f"{n}-{a}-{w}" for n, a, w in CASES]


@pytest.mark.parametrize("n,arch,against", CASES, ids=IDS)
def test_prefill_and_decode_logits_match(runs, n, arch, against):
    want = _want(runs, n, arch, against)
    for got in runs["port"][n]:                   # every rank's
        rec = got["serve"][arch]
        assert rec["prefill"].shape == want["prefill"].shape
        _close(rec["prefill"], want["prefill"], LOGIT_TOL)
        assert len(rec["decode"]) == STEPS
        for g, w in zip(rec["decode"], want["decode"]):
            _close(g, w, LOGIT_TOL)


@pytest.mark.parametrize("n,arch,against", CASES, ids=IDS)
def test_greedy_tokens_match(runs, n, arch, against):
    want = _want(runs, n, arch, against)
    toks = [np.argmax(w, -1) for w in [want["prefill"]] + want["decode"]]
    for got in runs["port"][n]:
        rec = got["serve"][arch]
        mine = [np.argmax(g, -1) for g in [rec["prefill"]] + rec["decode"]]
        for a, b in zip(mine, toks):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(rec["serve_tokens"], toks[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,arch,against", CASES, ids=IDS)
def test_each_ranks_cache_holds_its_slots(runs, n, arch, against):
    want = _want(runs, n, arch, against)
    G = get_config(arch, reduced=True).with_(**_kw(arch, n)).groups
    for rank, got in enumerate(runs["port"][n]):
        rec = got["serve"][arch]
        mine = slice(rank * G // n, (rank + 1) * G // n)
        for part in ("cache_prefill", "cache"):
            assert set(rec[part]) == set(want[part]) == {"k", "v"}
            for k, w in want[part].items():
                assert rec[part][k].shape[2] == G // n
                _close(rec[part][k], w[:, :, mine], CACHE_TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_shares_are_the_full_params(runs, n, arch):
    want = _unstack(runs["trees"][arch])
    got = runs["port"][n][0]["serve"][arch]["gathered"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_are_the_dry_runs(runs, n, arch):
    """Each rank's params and cache hold ``device_bytes``' per-device
    bytes of the reference's rules on a MeshShape (1, n), a 1 / n share;
    the cut leaves are smaller than their whole."""
    cfg = get_config(arch, reduced=True).with_(dtype="float32",
                                               **_kw(arch, n))
    model = build(cfg)
    shape = MeshShape(("data", "model"), (1, n))
    params = model.param_tree(None)
    g_par, d_par = device_bytes(params, param_shardings(cfg, shape, params),
                                shape)
    _, _, _, _, pos0, steps = next(c for c in runs["serving"][n]
                                   if c[0] == arch)
    cache = model.cache_spec(B, pos0 + steps)
    g_cache, d_cache = device_bytes(
        cache, cache_shardings(cfg, shape, B, cache), shape)
    assert d_cache * n == g_cache
    assert d_par < g_par
    for got in runs["port"][n]:
        rec = got["serve"][arch]
        assert rec["param_bytes"] == d_par
        assert rec["cache_bytes"] == d_cache


def test_data_sharded_serving_matches_the_reference(runs):
    """On (2, 2) the steps take and give the global batch's rows: each
    rank's prefill logits and serve tokens are all 4 rows', its
    ``decode_step`` logits and cache its 2 rows (its half of the KV
    slots)."""
    want = runs["single"]["data"]
    G = get_config(DATA_SERVE, reduced=True).with_(
        **_kw(DATA_SERVE, 2)).groups
    for got in runs["port"][4]:
        rec = got["data_serve"][DATA_SERVE]
        d, m = got["coords"]
        assert rec["prefill"].shape[0] == DATA_B
        _close(rec["prefill"], want["prefill"], LOGIT_TOL)
        for g, w in zip(rec["decode"], want["decode"]):
            _close(g, w[2 * d:2 * d + 2], LOGIT_TOL)      # decode_step's
        toks = [np.argmax(w, -1) for w in want["decode"]]
        for a, b in zip(rec["serve_tokens"], toks):
            np.testing.assert_array_equal(a, b)
        for k, w in want["cache"].items():
            _close(rec["cache"][k], w[:, 2 * d:2 * d + 2,
                                      m * G // 2:(m + 1) * G // 2],
                   CACHE_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_cache_spec_under_the_mesh_is_the_ranks(runs, n):
    for got in runs["port"][n]:
        recs = list(got["serve"].values()) + list(got["data_serve"].values())
        for rec in recs:
            assert rec["cache_spec"] == {k: v.shape for k, v in
                                         rec["cache"].items()}


@pytest.mark.parametrize("n", WORLDS)
def test_whole_params_and_the_int8_cache_are_refused(runs, n):
    """Params not cut by ``shard_params`` raise rather than run every
    head on each rank; the int8 KV cache, on cut params, is no longer
    refused under a model axis: its prefill runs
    (tests/test_torch_int8_kv_mesh.py holds it to the reference)."""
    for got in runs["port"][n]:
        refused = got["refused"]
        assert refused["whole"].startswith("ValueError") \
            and "convert.shard_params" in refused["whole"]
        assert refused["int8"] is None


@pytest.mark.parametrize("sizes,arch", TRAIN, ids=[f"{s}-{a}" for s, a in
                                                   TRAIN])
def test_training_on_the_cut_weights_matches_the_reference(runs, sizes,
                                                           arch):
    got = runs["port"][4][0]["train"][(sizes, arch)]
    want = runs["train_want"][(sizes, arch)]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(got["grads"][name], w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("arch,kw,n,dim", [
    ("mistral_large_123b", {}, 4, "groups (KV slots) = 2"),
    ("olmoe_1b_7b", {"moe_impl": "shard_map"}, 8, "experts"),
    ("whisper_base", {"d_model": 130}, 4, "d_model = 130"),
    ("h2o_danube_1_8b", {"kv_groups": 3}, 3, "d_model = 256"),
    ("h2o_danube_1_8b", {"tie_embeddings": True}, 2,
     "a tied embedding in the dense family"),
])
def test_a_config_the_model_axis_cannot_cut_raises(arch, kw, n, dim):
    """The dim is named and nothing is replicated in its place; a tied
    embedding outside the audio family (whose head reads the embed's
    vocab rows) is not cut."""
    cfg = get_config(arch, reduced=True).with_(**kw)
    mesh = MeshShape(("data", "model"), (1, n))
    with pytest.raises(ValueError, match=dim.replace("(", r"\(")
                       .replace(")", r"\)")):
        shard_params(build(cfg).init(torch.Generator().manual_seed(0)),
                     mesh)


def test_tp_config_raises_the_kv_slots_to_the_axis():
    cfg = get_config("mistral_large_123b")
    assert cfg.groups == 8
    assert tp_config(cfg, 2) is cfg
    assert tp_config(cfg, 16).groups == 16
    assert tp_config(cfg, 16).padded_heads() % 16 == 0
