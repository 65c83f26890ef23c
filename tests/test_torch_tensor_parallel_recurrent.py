"""The reference's channel-parallel layout for the SSM and hybrid families
on a process mesh, on the CPU (gloo): ``convert.shard_params`` cuts every
leaf of falcon-mamba-7b and recurrentgemma-2b by ``sharding.param_pspec``
and the serving and training paths run on the rank's channels, heads and
vocab block.

Reduced falcon-mamba-7b (d_in 512, d_state 8, 2 layers) and reduced
recurrentgemma-2b (5 layers: one period and the 2-layer remainder, w
256, a prompt of 80 past its window of 64, ``kv_groups`` raised to the
model axis by ``sharding.tp_config``), fp32, B 3, on the reference's init
carried across by ``convert``, inputs from a numpy seed.  The port runs
them in gloo worlds of 2 and 4 ranks, meshes (1, 2) and (1, 4): the
prefill step, 3 greedy ``decode_step``s and the serve step's tokens.  The
reference runs them single-device in this process and once, in one
subprocess with 4 forced host devices, as its own tensor-parallel path:
the steps jitted with ``param_shardings`` / ``batch_shardings`` /
``cache_shardings`` on an Auto (1, 4) ``Mesh`` built with the
constructor (ROADMAP Queue 3 item 6).

Held (``tests/test_torch_tensor_parallel.py``'s contract): logits within
2e-4, the same greedy tokens (the serve step's too), each rank's block of
every cache leaf (Mamba's ``h`` / ``conv``, the RG-LRU's state and conv
tail, the attention's KV slots) within 1e-5 of the reference cache's
block after the prefill and after the decode steps; the gathered params
exactly the full params (mamba's ``in_proj`` holds a block of each of its
halves, ``xi | z``); a rank's param and cache bytes equal to
``sharding.device_bytes`` on a ``MeshShape`` of the same sizes;
``cache_spec`` under the mesh the rank's shapes.  Training: falcon-mamba
on (1, 4) and recurrentgemma on (2, 2), ``loss_and_grads(mesh=)`` against
``jax.value_and_grad`` single-device: the loss within 1e-5 relative and
every gathered gradient leaf within 2e-4 * max|g| (only these catch a
missing ``pvary`` after ``x_proj``'s all_reduce, or a gather of the
RG-LRU's xc whose backward does not sum).  ``check_tp`` names every dim
the axis cannot cut.
"""
import dataclasses
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
from repro_torch.models.convert import share_of, shard_params
from repro_torch.models.sharding import (TP_FAMILIES, cache_shardings,
                                         device_bytes, param_shardings,
                                         tp_config)

import _torch_mesh_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-4
CACHE_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
B, STEPS = 3, 3
ARCHS = ("falcon_mamba_7b", "recurrentgemma_2b")
PROMPT = {"falcon_mamba_7b": 24, "recurrentgemma_2b": 80}
WORLDS = (2, 4)
TRAIN = (((1, 4), "falcon_mamba_7b"), ((2, 2), "recurrentgemma_2b"))
TRAIN_SEQ = {"falcon_mamba_7b": 32, "recurrentgemma_2b": 72}

SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import build, get_config, runtime
    from repro.models.sharding import (batch_pspec, batch_shardings,
                                       cache_shardings, param_shardings)

    def flat(tree):
        return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

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
            for k, v in flat(cache).items():
                out[f"{arch}/cache_prefill/{k}"] = v
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            for i in range(steps):
                logits, cache = decode(params, cache, tok,
                                       jnp.asarray(pos0 + i, jnp.int32))
                out[f"{arch}/decode/{i}"] = np.asarray(logits)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
            for k, v in flat(cache).items():
                out[f"{arch}/cache/{k}"] = v
    np.savez(sys.argv[2], **out)
""")


def _kw(arch, n):
    """The config overrides of ``arch`` on a model axis of ``n``: its KV
    slots raised to ``n`` (``sharding.tp_config``; none for the SSM)."""
    kv = tp_config(get_config(arch, reduced=True), n).kv_groups
    return {"kv_groups": kv} if kv else {}


def _jflat(tree):
    """``{dotted path: array}`` of a JAX pytree, the names of
    ``_torch_mesh_ranks.flat_cache``."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unstack(tree, cfg):
    """The reference's stacked params as the port's dotted names: an SSM's
    ``layers.*`` split along the layers; the hybrid's period i's ``l{j}``
    as layer ``3 i + j`` and ``rem{r}`` as layer ``3 P + r``."""
    out = {}
    for name, a in _jflat(tree).items():
        if not name.startswith("layers."):
            out[name] = a
            continue
        rest = name[len("layers."):]
        if rest.startswith("periods."):
            j, leaf = rest[len("periods.l"):].split(".", 1)
            for i in range(a.shape[0]):
                out[f"layers.{3 * i + int(j)}.{leaf}"] = a[i]
        elif rest.startswith("rem"):
            r, leaf = rest[len("rem"):].split(".", 1)
            period = len(cfg.hybrid.pattern)
            out[f"layers.{period * (cfg.n_layers // period) + int(r)}."
                f"{leaf}"] = a
        else:
            for i in range(a.shape[0]):
                out[f"layers.{i}.{rest}"] = a[i]
    return out


def _batch(cfg, rng, n, S, labels=False):
    batch = {"tokens": rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)
        batch["labels"][rng.random((n, S)) < 0.1] = -1
    return batch


def _jcfg(arch, n):
    return jget_config(arch, reduced=True).with_(dtype="float32",
                                                 **_kw(arch, n))


def _reference(jm, tree, batch, pos0):
    """The reference single-device: prefill logits and cache, then STEPS
    greedy decode steps' logits and the cache after them."""
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache = jm.prefill(params, b, cache_len=pos0 + STEPS)
    out = {"prefill": np.asarray(logits), "cache_prefill": _jflat(cache),
           "decode": []}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(STEPS):
        logits, cache = jm.decode_step(params, cache, tok,
                                       jnp.asarray(pos0 + i, jnp.int32))
        out["decode"].append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out["cache"] = _jflat(cache)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's TP subprocess and the port's worlds of 2 and 4
    ranks, at once; meanwhile the reference single-device in this
    process."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    rng = np.random.default_rng(31)
    serving = {n: [] for n in WORLDS}
    trees = {}
    for i, arch in enumerate(ARCHS):
        batch = _batch(get_config(arch, reduced=True), rng, B, PROMPT[arch])
        for n in WORLDS:
            # the hybrid's padded q heads follow its KV slots: a tree a world
            trees[(n, arch)] = jax.tree.map(np.asarray, jbuild(
                _jcfg(arch, n)).init(jax.random.key(i)))
            serving[n].append((arch, _kw(arch, n), trees[(n, arch)], batch,
                               PROMPT[arch], STEPS))
    training = []
    for sizes, arch in TRAIN:
        tree = jax.tree.map(np.asarray, jbuild(_jcfg(arch, sizes[1])).init(
            jax.random.key(7)))
        training.append((sizes, arch, _kw(arch, sizes[1]), tree, _batch(
            get_config(arch, reduced=True), rng, 2, TRAIN_SEQ[arch],
            labels=True)))
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
                run_world, ranks.tp_recurrent_rank, n, backend="gloo",
                devices="cpu", timeout_s=240,
                args=(n, serving[n], training if n == 4 else []))
                for n in WORLDS}
            single = {(n, c[0]): _reference(jbuild(_jcfg(c[0], n)), c[2],
                                            c[3], c[4])
                      for n in WORLDS for c in serving[n]}
            train_want = {}
            for sizes, arch, _, tree, batch in training:
                jcfg = _jcfg(arch, sizes[1])
                model = jbuild(jcfg)
                (loss, _), g = jax.value_and_grad(
                    lambda p: model.loss(p, jax.tree.map(jnp.asarray, batch)),
                    has_aux=True)(jax.tree.map(jnp.asarray, tree))
                train_want[(sizes, arch)] = {
                    "loss": float(loss),
                    "grads": _unstack(jax.tree.map(np.asarray, g), jcfg)}
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


def _block(full, mine, rank, n):
    """Rank ``rank``'s block of the reference's ``full`` leaf: along the
    one axis where the rank's leaf ``mine`` holds a 1 / n share."""
    axes = [i for i, (a, b) in enumerate(zip(full.shape, mine.shape))
            if a != b]
    assert len(axes) == 1 and full.ndim == mine.ndim, (full.shape,
                                                       mine.shape)
    ax, w = axes[0], mine.shape[axes[0]]
    assert full.shape[ax] == n * w
    return np.take(full, range(rank * w, (rank + 1) * w), axis=ax)


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
def test_each_ranks_cache_holds_its_block(runs, n, arch, against):
    """Every leaf of the rank's cache is a 1 / n block of the reference's
    along one axis (Mamba's d_in, the RG-LRU's w, the KV slots), after
    the prefill and after the decode steps."""
    want = _want(runs, n, arch, against)
    for rank, got in enumerate(runs["port"][n]):
        rec = got["serve"][arch]
        for part in ("cache_prefill", "cache"):
            assert set(rec[part]) == set(want[part])
            for k, w in want[part].items():
                _close(rec[part][k], _block(w, rec[part][k], rank, n),
                       CACHE_TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_shares_are_the_full_params(runs, n, arch):
    """``convert.gather_params`` gives back every leaf bit for bit,
    mamba's ``in_proj`` (a block of each half a rank) included."""
    want = _unstack(runs["trees"][(n, arch)], _jcfg(arch, n))
    got = runs["port"][n][0]["serve"][arch]["gathered"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_are_the_dry_runs(runs, n, arch):
    """Each rank's params and cache hold ``device_bytes``' per-device
    bytes of the reference's rules on a MeshShape (1, n); the cache a 1 /
    n share, the params less than their whole."""
    cfg = get_config(arch, reduced=True).with_(dtype="float32",
                                               **_kw(arch, n))
    model = build(cfg)
    shape = MeshShape(("data", "model"), (1, n))
    params = model.param_tree(None)
    g_par, d_par = device_bytes(params, param_shardings(cfg, shape, params),
                                shape)
    cache = model.cache_spec(B, PROMPT[arch] + STEPS)
    g_cache, d_cache = device_bytes(
        cache, cache_shardings(cfg, shape, B, cache), shape)
    assert d_cache * n == g_cache
    assert d_par < g_par
    for got in runs["port"][n]:
        rec = got["serve"][arch]
        assert rec["param_bytes"] == d_par
        assert rec["cache_bytes"] == d_cache


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_under_the_mesh_is_the_ranks(runs, n, arch):
    for got in runs["port"][n]:
        rec = got["serve"][arch]
        assert rec["cache_spec"] == {k: v.shape for k, v in
                                     rec["cache"].items()}


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


class _Coords:
    """What ``runtime.take_share`` reads of a mesh, at one rank's
    coordinate on a (1, n) mesh."""

    def __init__(self, n, rank):
        self.n, self.rank = n, rank
        self.shape = {"data": 1, "model": n}

    def axis_size(self, axes):
        return self.n

    def index(self, axes):
        return self.rank


@pytest.mark.parametrize("n", [2, 4])
def test_in_proj_share_is_a_block_of_each_half(n):
    """A rank's ``in_proj`` is ``[xi's channel block | z's channel block]``
    (d, 2 d_in / n), not the rank's contiguous block of the 2 d_in columns;
    every other leaf is its contiguous block."""
    cfg = get_config("falcon_mamba_7b", reduced=True)
    d_in = cfg.ssm.expand * cfg.d_model
    w = torch.arange(cfg.d_model * 2 * d_in, dtype=torch.float32).view(
        cfg.d_model, 2 * d_in)
    k = d_in // n
    for r in range(n):
        got = share_of(cfg, "layers.0.mamba.in_proj.w", w, _Coords(n, r))
        want = torch.cat([w[:, r * k:(r + 1) * k],
                          w[:, d_in + r * k:d_in + (r + 1) * k]], 1)
        assert torch.equal(got, want)
        got = share_of(cfg, "layers.0.mamba.out_proj.w", w.T, _Coords(n, r))
        assert torch.equal(got, w.T[r * 2 * k:(r + 1) * 2 * k])


def test_the_recurrent_families_and_audio_are_cut():
    assert {"ssm", "hybrid", "audio"} <= set(TP_FAMILIES)
    cfg = get_config("falcon_mamba_7b", reduced=True)
    assert tp_config(cfg, 4) is cfg            # no KV slots to raise


@pytest.mark.parametrize("arch,change,n,dim", [
    ("falcon_mamba_7b", {"d_model": 264}, 16, "d_model = 264"),
    ("falcon_mamba_7b", {}, 128, "d_inner / n = 4"),
    ("recurrentgemma_2b", {"lru_width": 260}, 8, "lru_width = 260"),
    ("whisper_base", {"d_ff": 250}, 4, "d_ff = 250"),
])
def test_a_recurrent_config_the_model_axis_cannot_cut_raises(arch, change,
                                                             n, dim):
    """The dim is named and nothing is replicated in its place (the audio
    family is cut too)."""
    cfg = get_config(arch, reduced=True)
    if "lru_width" in change:
        cfg = tp_config(cfg.with_(hybrid=dataclasses.replace(
            cfg.hybrid, **change)), n)
    else:
        cfg = cfg.with_(**change)
    with pytest.raises(ValueError, match=dim.replace("(", r"\(")
                       .replace(")", r"\)")):
        shard_params(build(cfg).init(torch.Generator().manual_seed(0)),
                     MeshShape(("data", "model"), (1, n)))
