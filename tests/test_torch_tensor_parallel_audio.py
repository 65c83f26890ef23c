"""The reference's tensor-parallel layout for the audio family on a
process mesh, on the CPU (gloo): ``convert.shard_params`` cuts every leaf
of whisper-base by ``sharding.param_pspec`` (the tied ``embed`` by vocab
rows, ``dec_pos`` whole, the encoder's and decoder's attention, the
cross-attention and the MLPs as the dense family's) and the serving and
training paths run on the rank's rows, heads and ff columns.

Reduced whisper-base (d 128, 4 heads, vocab 512, 2 encoder + 2 decoder
layers), fp32, B 3, 40 frames and a 16-token decoder prompt from a numpy
seed, on the reference's init carried across by ``convert``.  The port
runs it in gloo worlds of 2 and 4 ranks, meshes (1, 2) and (1, 4): the
prefill step, 3 greedy ``decode_step``s and the serve step's tokens.  The
reference runs it single-device in this process and once, in one
subprocess with 4 forced host devices, as its own tensor-parallel path:
the steps jitted with ``param_shardings`` / ``batch_shardings`` /
``cache_shardings`` on an Auto (1, 4) ``Mesh`` built with the
constructor (ROADMAP Queue 3 item 6).

Held (``tests/test_torch_tensor_parallel.py``'s contract): logits within
2e-4, the same greedy tokens (the serve step's too), each rank's block of
``k``, ``v``, ``xk`` and ``xv`` within 1e-5 of the reference cache's
after the prefill and after the decode steps; the gathered params exactly
the full params, the embed's vocab rows included; a rank's param and
cache bytes equal to ``sharding.device_bytes`` on a ``MeshShape`` of the
same sizes; ``cache_spec`` under the mesh the rank's shapes; B 4 on (2,
2): the steps take and give the global batch's rows.  Training,
``loss_and_grads(mesh=)`` against ``jax.value_and_grad`` single-device,
on (2, 1) (the data axis alone: the loss must be the global masked mean,
the two data ranks holding different counts of -1 labels), (1, 4) and
(2, 2): the loss within 1e-5 relative and every gathered gradient leaf
within 2e-4 * max|g|, the tied ``embed``'s (the lookup's rows and the
head's) included.
"""
import os
import pickle
import re
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
from repro_torch.models.sharding import (TP_FAMILIES, cache_shardings,
                                         check_tp, device_bytes, mesh_pspec,
                                         param_shardings, tp_config)

import _torch_mesh_ranks as ranks

REPO = Path(__file__).resolve().parents[1]
ARCH = "whisper_base"
LOGIT_TOL = 2e-4
CACHE_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
B, STEPS = 3, 3
FRAMES, PROMPT = 40, 16
WORLDS = (2, 4)
#: (mesh sizes, world): (2, 1) is the data axis alone
TRAIN = (((2, 1), 2), ((1, 4), 4), ((2, 2), 4))
TRAIN_B, TRAIN_S = 4, 12
DATA_B = 4                # on (2, 2): 2 rows a data rank

SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import build, get_config, runtime
    from repro.models.sharding import (batch_pspec, batch_shardings,
                                       cache_shardings, param_shardings)

    with open(sys.argv[1], "rb") as f:
        arch, kw, tree, batch, pos0, steps = pickle.load(f)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
    cfg = get_config(arch, reduced=True).with_(dtype="float32", **kw)
    model = build(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    n = batch["tokens"].shape[0]
    out = {}
    with mesh, runtime.use_mesh(mesh):
        p_sh = param_shardings(cfg, mesh, params)
        c_sh = cache_shardings(cfg, mesh, n, model.cache_spec(
            n, batch["frames"].shape[1]))
        t_sh = NamedSharding(mesh, batch_pspec(mesh, n, 2))
        prefill = jax.jit(model.prefill,
                          in_shardings=(p_sh, batch_shardings(mesh, n, b)),
                          out_shardings=(None, c_sh))
        decode = jax.jit(
            model.decode_step,
            in_shardings=(p_sh, c_sh, t_sh, NamedSharding(mesh, P())),
            out_shardings=(None, c_sh))
        logits, cache = prefill(params, b)
        out["prefill"] = np.asarray(logits)
        for k, v in cache.items():
            out[f"cache_prefill/{k}"] = np.asarray(v)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(steps):
            logits, cache = decode(params, cache, tok,
                                   jnp.asarray(pos0 + i, jnp.int32))
            out[f"decode/{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for k, v in cache.items():
            out[f"cache/{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _kw(n):
    return {"kv_groups": tp_config(get_config(ARCH, reduced=True),
                                   n).kv_groups}


def _unstack(tree):
    """The reference's stacked params as the port's dotted names."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(k.key for k in path)
        group, _, rest = name.partition(".")
        if group in ("enc_layers", "dec_layers"):
            for i in range(a.shape[0]):
                out[f"{group}.{i}.{rest}"] = a[i]
        else:
            out[name] = a
    return out


def _batch(cfg, rng, n, S, frames=FRAMES, labels=None):
    """Frames and tokens of ``n`` rows; with ``labels`` a fraction of -1
    labels a row (the data ranks' rows differ in their count)."""
    batch = {"frames": rng.standard_normal((n, frames, cfg.d_model),
                                           dtype=np.float32),
             "tokens": rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)}
    if labels is not None:
        lab = rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)
        for row, frac in enumerate(labels):
            lab[row, rng.random(S) < frac] = -1
        batch["labels"] = lab
    return batch


def _reference(jm, tree, batch, pos0):
    """The reference single-device: prefill logits and cache, then STEPS
    greedy decode steps' logits and the cache after them."""
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache = jm.prefill(params, b)
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


def _jm(n):
    return jbuild(jget_config(ARCH, reduced=True).with_(dtype="float32",
                                                        **_kw(n)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's TP subprocess and the port's worlds of 2 and 4
    ranks, at once; meanwhile the reference single-device in this
    process."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("tp_audio")
    rng = np.random.default_rng(11)
    cfg = get_config(ARCH, reduced=True)
    tree = jax.tree.map(np.asarray, _jm(4).init(jax.random.key(5)))
    batch = _batch(cfg, rng, B, PROMPT)
    serving = {n: [(ARCH, _kw(n), tree, batch, PROMPT, STEPS)]
               for n in WORLDS}
    data_serving = [(ARCH, _kw(2), tree, _batch(cfg, rng, DATA_B, PROMPT),
                     PROMPT, STEPS)]
    # each data rank's two rows: rank 0 about half -1, rank 1 about 5 %
    train_batch = _batch(cfg, rng, TRAIN_B, TRAIN_S,
                         labels=(0.5, 0.5, 0.05, 0.05))
    training = {n: [(sizes, ARCH, _kw(sizes[1]), tree, train_batch)
                    for sizes, world in TRAIN if world == n]
                for n in WORLDS}
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(serving[4][0], f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / "case.pkl"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            worlds = {n: pool.submit(
                run_world, ranks.tp_rank, n, backend="gloo", devices="cpu",
                timeout_s=240, args=(n, serving[n], training[n],
                                     data_serving if n == 4 else ()))
                for n in WORLDS}
            single = {n: _reference(_jm(n), tree, batch, PROMPT)
                      for n in WORLDS}
            single["data"] = _reference(_jm(2), tree, data_serving[0][3],
                                        PROMPT)
            train_want = {}
            for sizes, _ in TRAIN:
                model = _jm(sizes[1])
                (loss, _), g = jax.value_and_grad(
                    lambda p: model.loss(p, jax.tree.map(jnp.asarray,
                                                         train_batch)),
                    has_aux=True)(jax.tree.map(jnp.asarray, tree))
                train_want[sizes] = {
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
    ref_tp = {"prefill": ref["prefill"],
              "decode": [ref[f"decode/{i}"] for i in range(STEPS)],
              **{part: {k[len(f"{part}/"):]: v for k, v in ref.items()
                        if k.startswith(f"{part}/")}
                 for part in ("cache_prefill", "cache")}}
    return {"port": port, "single": single, "ref_tp": ref_tp, "tree": tree,
            "train_want": train_want}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


CASES = [(2, "single"), (4, "single"), (4, "ref_tp")]
IDS = [f"{n}-{w}" for n, w in CASES]


def _want(runs, n, against):
    return runs["single"][n] if against == "single" else runs["ref_tp"]


@pytest.mark.parametrize("n,against", CASES, ids=IDS)
def test_prefill_and_decode_logits_match(runs, n, against):
    want = _want(runs, n, against)
    for got in runs["port"][n]:                   # every rank's
        rec = got["serve"][ARCH]
        assert rec["prefill"].shape == want["prefill"].shape
        _close(rec["prefill"], want["prefill"], LOGIT_TOL)
        assert len(rec["decode"]) == STEPS
        for g, w in zip(rec["decode"], want["decode"]):
            _close(g, w, LOGIT_TOL)


@pytest.mark.parametrize("n,against", CASES, ids=IDS)
def test_greedy_tokens_match(runs, n, against):
    want = _want(runs, n, against)
    toks = [np.argmax(w, -1) for w in [want["prefill"]] + want["decode"]]
    for got in runs["port"][n]:
        rec = got["serve"][ARCH]
        mine = [np.argmax(g, -1) for g in [rec["prefill"]] + rec["decode"]]
        for a, b in zip(mine, toks):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(rec["serve_tokens"], toks[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,against", CASES, ids=IDS)
def test_each_ranks_caches_hold_its_slots(runs, n, against):
    """``k`` / ``v`` (L, B, G, cap, hd) and ``xk`` / ``xv`` (L, B, G,
    S_enc, hd): the rank's G / n slots of each, after the prefill and
    after the decode steps."""
    want = _want(runs, n, against)
    G = get_config(ARCH, reduced=True).with_(**_kw(n)).groups
    for rank, got in enumerate(runs["port"][n]):
        rec = got["serve"][ARCH]
        mine = slice(rank * G // n, (rank + 1) * G // n)
        for part in ("cache_prefill", "cache"):
            assert set(rec[part]) == set(want[part]) == {"k", "v", "xk",
                                                         "xv"}
            for k, w in want[part].items():
                assert rec[part][k].shape[2] == G // n
                _close(rec[part][k], w[:, :, mine], CACHE_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_gathered_shares_are_the_full_params(runs, n):
    want = _unstack(runs["tree"])
    got = runs["port"][n][0]["serve"][ARCH]["gathered"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_rank_bytes_are_the_dry_runs(runs, n):
    """Each rank's params and caches hold ``device_bytes``' per-device
    bytes of the reference's rules on a MeshShape (1, n); ``dec_pos`` and
    the norms are whole, so the params a little over 1 / n."""
    cfg = get_config(ARCH, reduced=True).with_(dtype="float32", **_kw(n))
    model = build(cfg)
    shape = MeshShape(("data", "model"), (1, n))
    params = model.param_tree(None)
    g_par, d_par = device_bytes(params, param_shardings(cfg, shape, params),
                                shape)
    cache = model.cache_spec(B, FRAMES)
    g_cache, d_cache = device_bytes(
        cache, cache_shardings(cfg, shape, B, cache), shape)
    assert d_cache * n == g_cache
    assert g_par / n < d_par < g_par
    for got in runs["port"][n]:
        rec = got["serve"][ARCH]
        assert rec["param_bytes"] == d_par
        assert rec["cache_bytes"] == d_cache


@pytest.mark.parametrize("n", WORLDS)
def test_cache_spec_under_the_mesh_is_the_ranks(runs, n):
    for got in runs["port"][n]:
        recs = list(got["serve"].values()) + list(got["data_serve"].values())
        for rec in recs:
            assert rec["cache_spec"] == {k: v.shape for k, v in
                                         rec["cache"].items()}


def test_data_sharded_serving_matches_the_reference(runs):
    """On (2, 2) the steps take and give the global batch's rows: each
    rank's prefill logits and serve tokens are all 4 rows', its
    ``decode_step`` logits and caches its 2 rows (its half of the KV
    slots)."""
    want = runs["single"]["data"]
    G = get_config(ARCH, reduced=True).with_(**_kw(2)).groups
    for got in runs["port"][4]:
        rec = got["data_serve"][ARCH]
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
def test_whole_params_are_refused(runs, n):
    """Params not cut by ``shard_params`` raise at the embedding rather
    than run every head and vocab row on each rank."""
    for got in runs["port"][n]:
        whole = got["refused"]["whole"]
        assert whole.startswith("ValueError") \
            and "convert.shard_params" in whole


@pytest.mark.parametrize("sizes", [s for s, _ in TRAIN],
                         ids=[f"{s[0]}x{s[1]}" for s, _ in TRAIN])
def test_training_on_the_cut_weights_matches_the_reference(runs, sizes):
    """The loss is the global masked mean over the data ranks' rows (their
    -1 labels differ in count) and every leaf's gradient the reference's,
    the tied ``embed``'s included (its rows read by the lookup and, all of
    them, by the head)."""
    world = dict(TRAIN)[sizes]
    got = runs["port"][world][0]["train"][(sizes, ARCH)]
    want = runs["train_want"][sizes]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    assert "embed" in want["grads"]
    for name, w in want["grads"].items():
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(got["grads"][name], w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_audio_is_a_family_the_mesh_cuts():
    """The layout's leaves: the tied embed by its vocab rows, ``dec_pos``
    and the norms whole, the cross-attention as the self-attention."""
    assert "audio" in TP_FAMILIES
    cfg = get_config(ARCH, reduced=True)
    assert mesh_pspec(cfg, ("embed",), 2, 4) == ("model", None)
    assert mesh_pspec(cfg, ("dec_pos",), 2, 4) == (None, None)
    assert mesh_pspec(cfg, ("ln_e", "scale"), 1, 4) == (None,)
    for name, spec in (("wq", (None, "model")), ("wk", (None, "model")),
                       ("wv", (None, "model")), ("wo", ("model", None))):
        assert mesh_pspec(cfg, ("dec_layers", "0", "xattn", name, "w"), 2,
                          4) == spec
    check_tp(cfg, 4)
    assert tp_config(cfg, 4) is cfg             # 4 KV slots already


@pytest.mark.parametrize("change,n,dim", [
    ({"d_model": 130}, 4, "d_model = 130"),
    ({"d_ff": 250}, 4, "d_ff = 250"),
    ({"n_heads": 6, "n_kv_heads": 6}, 4, "groups (KV slots) = 6"),
    ({"n_heads": 6, "n_kv_heads": 6}, 4, "n_kv_heads * hd = 126"),
    ({"d_model": 128 * 3, "n_heads": 6, "n_kv_heads": 6}, 4,
     "padded_heads() = 6"),
])
def test_an_audio_config_the_model_axis_cannot_cut_raises(change, n, dim):
    """Each dim the axis cannot cut is named; nothing is replicated in its
    place."""
    cfg = get_config(ARCH, reduced=True).with_(**change)
    with pytest.raises(ValueError, match=re.escape(dim)):
        shard_params(build(cfg).init(torch.Generator().manual_seed(0)),
                     MeshShape(("data", "model"), (1, n)))
