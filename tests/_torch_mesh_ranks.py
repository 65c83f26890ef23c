"""The functions each rank of the port's process worlds runs in
``tests/test_torch_runtime.py``, ``test_torch_mesh_moe.py``,
``test_torch_seq_shard.py``, ``test_torch_kge_mesh.py``,
``test_torch_tensor_parallel*.py`` and ``test_torch_int8_kv_mesh.py``.

``launch.mesh.run_world`` starts fresh interpreters that import these by
name, so this module imports neither JAX nor the JAX package (it loads
in every rank) and nothing heavy at the top.  Each function builds its
``ProcessMesh`` on the CPU and returns numpy results from rank 0 (every
rank takes part in every collective).
"""
import time

import numpy as np
import torch


def _mesh(names, sizes):
    from repro_torch.launch.mesh import ProcessMesh
    return ProcessMesh.build(names, sizes, "cpu")


# ----------------------------- runtime -------------------------------- #
def runtime_rank(rank):
    """(2, 2) and (pod 2, data 1, model 2) meshes over 4 ranks: each
    rank's coordinates and groups, and every collective's forward and
    backward on rank-numbered inputs."""
    import torch.distributed as dist
    from repro_torch.models import runtime
    mesh = _mesh(("data", "model"), (2, 2))
    out = {"coords": mesh.coords, "shape": mesh.shape,
           "index": {a: mesh.index(a) for a in ("data", "model",
                                                ("data", "model"))},
           "groups": {k: dist.get_process_group_ranks(g)
                      for k, g in mesh.groups.items()}}
    model = mesh.group("model")
    v = float(rank + 1)

    x = torch.full((3,), v, requires_grad=True)
    y = runtime.psum_identity_bwd(x * 1.0, model)
    (y * v).sum().backward()
    out["psum"] = (y.detach().numpy(), x.grad.numpy())

    x = torch.full((3,), 2.0, requires_grad=True)
    y = runtime.pvary(x, model)
    (y * v).sum().backward()
    out["pvary"] = (y.detach().numpy(), x.grad.numpy())

    x = torch.tensor(v, requires_grad=True)
    y = runtime.pmean(x, mesh.group(("data", "model")))
    (y * 3.0).backward()
    out["pmean"] = (float(y), float(x.grad))

    x = torch.full((1, 2, 2), v, requires_grad=True)
    y = runtime.gather_seq(x, model)
    (y * torch.arange(8.0).view(1, 4, 2)).sum().backward()
    out["gather_seq"] = (y.detach().numpy(), x.grad.numpy())

    x = torch.arange(8.0).view(1, 4, 2).requires_grad_(True)
    y = runtime.slice_seq(x, model)
    (y * v).sum().backward()
    out["slice_seq"] = (y.detach().numpy(), x.grad.numpy())

    for name, fn in (("gather_last", runtime.gather_last),
                     ("gather_last_summed", runtime.gather_last_summed)):
        x = torch.full((2, 3), v, requires_grad=True)
        y = fn(x, model)
        (y * torch.arange(12.0).view(2, 6) * v).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())

    full = torch.arange(24.0).view(4, 6)
    share = runtime.take_share(full, ("model", None), mesh)
    both = runtime.take_share(full, (("data", "model"), None), mesh)
    out["share"] = (share.numpy(), both.numpy(),
                    runtime.gather_share(share, ("model", None), mesh)
                    .numpy(),
                    runtime.gather_share(both, (("data", "model"), None),
                                         mesh).numpy(),
                    runtime.gather_share(full, (None, None), mesh).numpy())

    pod = _mesh(("pod", "data", "model"), (2, 1, 2))
    out["pod"] = {"coords": pod.coords,
                  "index": pod.index(("pod", "data")),
                  "groups": {k: dist.get_process_group_ranks(g)
                             for k, g in pod.groups.items()}}
    try:
        pod.group("pod")
        out["pod"]["no_group"] = None
    except ValueError as e:
        out["pod"]["no_group"] = str(e)
    return out


def failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(30)        # rank 0 would wait: the helper must not


def hanging_rank(rank):
    if rank == 1:
        time.sleep(60)
    return rank


# ------------------------------- MoE ---------------------------------- #
def _grads_full(cfg, grads, mesh):
    """Every leaf of ``grads`` (the rank's shares) put back whole."""
    from repro_torch.models.convert import whole_of
    return {n: whole_of(cfg, n, g, mesh).numpy() for n, g in grads.items()}


def moe_loss_rank(rank, sizes, params, batch, cfg_kw, lr):
    """Reduced olmoe's loss and every gradient leaf on a ``sizes`` (data,
    model) mesh, for ``moe_impl`` "shard_map" and "gspmd", the experts'
    gradients gathered from the model ranks; then one
    ``make_train_step(mesh=)`` step at ``lr`` from the same params: its
    loss, and the params and Adam moments after it, gathered."""
    from repro_torch.models import build, get_config
    from repro_torch.models.convert import (gather_params, params_from_numpy,
                                            shard_params)
    from repro_torch.models.steps import loss_and_grads, make_train_step
    mesh = _mesh(("data", "model"), sizes)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for impl in ("shard_map", "gspmd"):
        cfg = get_config("olmoe_1b_7b", reduced=True).with_(
            moe_impl=impl, **cfg_kw)
        model = shard_params(params_from_numpy(build(cfg), params, "cpu"),
                             mesh)
        model._p().requires_grad_(True)
        loss, metrics, grads = loss_and_grads(model, batch, mesh)
        out[impl] = {"loss": float(loss), "aux": float(metrics["aux"]),
                     "experts": tuple(model.params["layers"][0]["moe"]
                                      ["gate"].shape),
                     "wq": tuple(model.params["layers"][0]["attn"]["wq"]
                                 ["w"].shape),
                     "grads": _grads_full(cfg, grads, mesh),
                     "params": {n: t.numpy() for n, t in
                                gather_params(model, mesh).items()}}
        step, opt = make_train_step(model, lr=lr, mesh=mesh)
        state = opt.init(dict(model.params.named_parameters()))
        state, metrics = step(state, batch)
        out[impl]["step"] = {
            "step": int(state.step), "loss": float(metrics["loss"]),
            "params": {n: t.numpy() for n, t in
                       gather_params(model, mesh).items()},
            "mu": _grads_full(cfg, state.mu, mesh),
            "nu": _grads_full(cfg, state.nu, mesh)}
    return out if rank == 0 else None


def moe_layer_rank(rank, layer, x, cfg_kw):
    """One MoE layer's forward (bf16) through ``moe_apply_shard_map`` on a
    (1, 2) mesh: y, aux and the dropped pairs summed over the ranks."""
    import torch.distributed as dist
    from repro_torch.models import blocks, get_config, runtime
    from repro_torch.models.sharding import mesh_pspec
    mesh = _mesh(("data", "model"), (1, 2))
    cfg = get_config("olmoe_1b_7b", reduced=True).with_(
        moe_impl="shard_map", **cfg_kw)
    p = {k: runtime.take_share(
        torch.from_numpy(v).to(cfg.jdtype),
        mesh_pspec(cfg, ("moe", k), v.ndim, 2), mesh)
        for k, v in layer.items()}
    drops = torch.zeros((), dtype=torch.int64)
    with runtime.use_mesh(mesh):
        y, aux = blocks.moe_dispatch(
            p, torch.from_numpy(x).to(cfg.jdtype), cfg, drops)
    dist.all_reduce(drops)
    return (y.float().numpy(), float(aux), int(drops)) if rank == 0 \
        else None


# --------------------------- sequence shard ---------------------------- #
def seq_shard_rank(rank, params, batch):
    """Reduced h2o-danube, fp32, on ``params`` (the reference's numpy
    tree) cut over ``"model"`` (``convert.shard_params``) on a (2, 2)
    mesh with and without ``seq_shard``: loss, every gradient leaf
    (gathered whole) and the residual rows each checkpointed block was
    given (what remat keeps); and the error for a sequence the model axis
    does not divide."""
    from repro_torch.models import build, get_config, lm
    from repro_torch.models.convert import params_from_numpy, shard_params
    from repro_torch.models.steps import loss_and_grads
    mesh = _mesh(("data", "model"), (2, 2))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    real = lm.checkpoint
    saved = []

    def recording(fn, *args, **kw):
        saved.append(tuple(args[1].shape))
        return real(fn, *args, **kw)

    lm.checkpoint = recording
    out = {}
    try:
        for seq in (False, True):
            cfg = get_config("h2o_danube_1_8b", reduced=True).with_(
                dtype="float32", seq_shard=seq)
            model = shard_params(params_from_numpy(build(cfg), params, "cpu"),
                                 mesh)
            model._p().requires_grad_(True)
            saved.clear()
            loss, _, grads = loss_and_grads(model, batch, mesh)
            out[seq] = {"loss": float(loss), "saved": list(saved),
                        "grads": _grads_full(cfg, grads, mesh)}
        odd = {k: v[:, :-1] for k, v in batch.items()}
        try:
            loss_and_grads(model, odd, mesh)
            out["odd"] = None
        except ValueError as e:
            out["odd"] = str(e)
    finally:
        lm.checkpoint = real
    return out if rank == 0 else None


# -------------------------- tensor parallel ---------------------------- #
def flat_cache(tree, prefix=""):
    """``{dotted path: leaf}`` of a cache: a dict of tensors, or the
    hybrid's dicts of tuples (``"periods.2.0"``, ``"rem.1.1"``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_cache(v, f"{prefix}{k}." if isinstance(
            v, (dict, list, tuple)) else f"{prefix}{k}"))
    return out


def _clone_cache(tree):
    if isinstance(tree, dict):
        return {k: _clone_cache(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_cache(v) for v in tree)
    return tree.clone()


def _serve_case(mesh, arch, kw, tree, batch, pos0, steps, lead):
    """One arch's serving path on ``mesh``, fp32, on the reference's
    params cut by ``convert.shard_params``: the prefill step's logits and
    cache, ``steps`` greedy ``decode_step``s on the rank's rows under
    ``use_mesh`` (each fed the last argmax: the logits, then the cache),
    the serve step's tokens
    from a copy of the prefill's cache; the rank's param and cache bytes;
    from the ``lead`` rank the gathered params."""
    from repro_torch.models import build, get_config, runtime
    from repro_torch.models.convert import (gather_params, params_from_numpy,
                                            shard_params)
    from repro_torch.models.lm import cache_nbytes
    from repro_torch.models.steps import (local_batch, make_prefill_step,
                                          make_serve_step)
    cfg = get_config(arch, reduced=True).with_(dtype="float32", **kw)
    model = shard_params(params_from_numpy(build(cfg), tree, "cpu"), mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, cache = make_prefill_step(model, mesh)(batch, pos0 + steps)
    out = {"prefill": logits.numpy(),
           "cache_prefill": {k: v.clone().numpy() for k, v in
                             flat_cache(cache).items()},
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.params.parameters())}
    first = logits.argmax(-1).to(torch.int32)
    served = _clone_cache(cache)
    # decode_step runs on the rank's rows (all of them on a (1, n) mesh)
    tok, decode = local_batch({"tok": first}, mesh)["tok"], []
    with runtime.use_mesh(mesh):
        for i in range(steps):
            lg, cache = model.decode_step(cache, tok, pos0 + i)
            decode.append(lg.numpy())
            tok = lg.argmax(-1).to(torch.int32)
    serve, tok, tokens = make_serve_step(model, mesh), first, []
    for i in range(steps):
        tok, served = serve(served, tok, pos0 + i)
        tokens.append(tok.numpy())
    # an encoder-decoder's caches are laid out by its encoder frames
    seq = batch["frames"].shape[1] if "frames" in batch else pos0 + steps
    with runtime.use_mesh(mesh):
        spec = model.cache_spec(batch["tokens"].shape[0], seq)
    out.update(decode=decode, serve_tokens=tokens,
               cache={k: v.numpy() for k, v in flat_cache(cache).items()},
               cache_bytes=cache_nbytes(cache),
               cache_spec={k: tuple(v.shape) for k, v in
                           flat_cache(spec).items()})
    full = gather_params(model, mesh)
    if lead:
        out["gathered"] = {n: t.numpy() for n, t in full.items()}
    return out


def _train_case(mesh, arch, kw, tree, batch):
    """``steps.loss_and_grads`` of one arch, fp32, its params cut over
    ``"model"``: the loss and every gradient leaf gathered whole."""
    from repro_torch.models import build, get_config
    from repro_torch.models.convert import params_from_numpy, shard_params
    from repro_torch.models.steps import loss_and_grads
    cfg = get_config(arch, reduced=True).with_(dtype="float32", **kw)
    model = shard_params(params_from_numpy(build(cfg), tree, "cpu"), mesh)
    model._p().requires_grad_(True)
    loss, _, grads = loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
    return {"loss": float(loss), "grads": _grads_full(cfg, grads, mesh)}


def _refusals(mesh, arch, kw, tree, batch):
    """What the mesh's prefill step raises for whole (uncut) params, and
    for the int8 KV cache on cut ones (None: it ran)."""
    from repro_torch.models import build, get_config
    from repro_torch.models.convert import params_from_numpy, shard_params
    from repro_torch.models.steps import make_prefill_step
    cfg = get_config(arch, reduced=True).with_(dtype="float32", **kw)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, c, cut in (("whole", cfg, False),
                         ("int8", cfg.with_(kv_cache_dtype="int8"), True)):
        model = params_from_numpy(build(c), tree, "cpu")
        if cut:
            shard_params(model, mesh)
        try:
            make_prefill_step(model, mesh)(batch)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def tp_rank(rank, world, serving, training, data_serving=()):
    """The tensor-parallel layout in a world of ``world`` ranks: each
    serving case ``(arch, cfg kwargs, params, batch, pos0, steps)`` on a
    (1, world) mesh (:func:`_serve_case`), what the first one's arch
    refuses there (:func:`_refusals`), then each training case ``(mesh
    sizes, arch, cfg kwargs, params, batch)`` on its own mesh
    (:func:`_train_case`) and each ``data_serving`` case on a (2, world
    / 2) mesh.  Every rank returns its serving results; rank 0 the
    gathered params and the training results."""
    mesh = _mesh(("data", "model"), (1, world))
    out = {"serve": {arch: _serve_case(mesh, arch, kw, tree, batch, pos0,
                                       steps, rank == 0)
                     for arch, kw, tree, batch, pos0, steps in serving},
           "refused": _refusals(mesh, *serving[0][:4]), "train": {},
           "data_serve": {}}
    for sizes, arch, kw, tree, batch in training:
        res = _train_case(_mesh(("data", "model"), sizes), arch, kw, tree,
                          batch)
        out["train"][(sizes, arch)] = res if rank == 0 else None
    if data_serving:
        dmesh = _mesh(("data", "model"), (2, world // 2))
        out["coords"] = dmesh.coords
        for arch, kw, tree, batch, pos0, steps in data_serving:
            out["data_serve"][arch] = _serve_case(
                dmesh, arch, kw, tree, batch, pos0, steps, rank == 0)
    return out


def _int8_case(mesh, arch, kw, tree, batch, pos0, fed):
    """One dense arch with ``kv_cache_dtype="int8"`` on ``mesh``, fp32, on
    the reference's params cut by ``convert.shard_params``: the prefill
    step's logits and the rank's int8 cache; then each decode step of
    ``fed`` (``(token, the reference's whole int8 cache before it)``) on
    the rank's slot block of that cache, its logits, the rank's cache
    after it and the new slot's unquantized k and v (as ``decode_step``
    hands them to ``blocks.quantize_kv``, layer by layer); the rank's
    param and cache bytes and ``cache_spec`` under the mesh."""
    from repro_torch.models import blocks, build, get_config, runtime
    from repro_torch.models.convert import params_from_numpy, shard_params
    from repro_torch.models.lm import cache_nbytes
    from repro_torch.models.steps import make_prefill_step
    cfg = get_config(arch, reduced=True).with_(dtype="float32",
                                               kv_cache_dtype="int8", **kw)
    model = shard_params(params_from_numpy(build(cfg), tree, "cpu"), mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    steps = len(fed)
    logits, cache = make_prefill_step(model, mesh)(batch, pos0 + steps)
    out = {"prefill": logits.numpy(),
           "cache_prefill": {k: v.clone().numpy() for k, v in cache.items()},
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.params.parameters()),
           "cache_bytes": cache_nbytes(cache), "decode": []}
    n, i = mesh.shape["model"], mesh.index("model")
    quantize = blocks.quantize_kv
    for step, (tok, before) in enumerate(fed):
        G = before["k"].shape[2]
        mine = {k: torch.from_numpy(v[:, :, i * G // n:(i + 1) * G // n]
                                    .copy()) for k, v in before.items()}
        seen = []
        blocks.quantize_kv = lambda t: (seen.append(t.numpy().copy()),
                                        quantize(t))[1]
        try:
            with runtime.use_mesh(mesh):
                lg, mine = model.decode_step(mine, torch.from_numpy(tok),
                                             pos0 + step)
        finally:
            blocks.quantize_kv = quantize
        out["decode"].append({
            "logits": lg.numpy(),
            "cache": {k: v.numpy() for k, v in mine.items()},
            "fp": {"k": np.stack(seen[0::2]), "v": np.stack(seen[1::2])}})
    with runtime.use_mesh(mesh):
        spec = model.cache_spec(batch["tokens"].shape[0], pos0 + steps)
    out["cache_spec"] = {k: tuple(v.shape) for k, v in spec.items()}
    return out


def int8_rank(rank, world, cases):
    """The int8 KV cache under a model axis: each case ``(arch, cfg
    kwargs, params, batch, pos0, fed)`` on a (1, world) mesh
    (:func:`_int8_case`).  Every rank returns its results."""
    mesh = _mesh(("data", "model"), (1, world))
    return {arch: _int8_case(mesh, arch, kw, tree, batch, pos0, fed)
            for arch, kw, tree, batch, pos0, fed in cases}


def tp_recurrent_rank(rank, world, serving, training):
    """The channel-parallel layout of the SSM and hybrid families in a
    world of ``world`` ranks: each serving case on a (1, world) mesh
    (:func:`_serve_case`), then each training case on its own mesh
    (:func:`_train_case`).  Every rank returns its serving results; rank
    0 the gathered params and the training results."""
    mesh = _mesh(("data", "model"), (1, world))
    out = {"serve": {arch: _serve_case(mesh, arch, kw, tree, batch, pos0,
                                       steps, rank == 0)
                     for arch, kw, tree, batch, pos0, steps in serving},
           "train": {}}
    for sizes, arch, kw, tree, batch in training:
        res = _train_case(_mesh(("data", "model"), sizes), arch, kw, tree,
                          batch)
        out["train"][(sizes, arch)] = res if rank == 0 else None
    return out


def chip_tp_rank(rank):
    """``chip_smoke``'s tensor-parallel mesh parts on a (1, 2) mesh on the
    CPU: mistral-large-123b and h2o-danube-1.8b at their reduced configs
    (each CONFIG swapped for REDUCED; prompts 24 and 96, past the reduced
    window of 64), the card's calls stubbed, failed checks collected."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import h2o_danube_1_8b, mistral_large_123b
    for mod in (h2o_danube_1_8b, mistral_large_123b):
        mod.CONFIG = mod.REDUCED
    failures = []
    chip_smoke.check = lambda ok, msg: ok or failures.append(msg)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    chip_smoke.MESH_TP_CHECKS = ((chip_smoke.MISTRAL_ARCH, 1, 24),
                                 (chip_smoke.LM_ARCH, 1, 96))
    chip_smoke.ZOO_PROMPT, chip_smoke.ZOO_STEPS = 24, 3
    mesh = _mesh(("data", "model"), (1, 2))
    checks = [chip_smoke._mesh_tp_check(mesh, *c)
              for c in chip_smoke.MESH_TP_CHECKS]
    return {"checks": checks, "tp": chip_smoke._mesh_tp(mesh),
            "failures": failures}


def chip_rec_rank(rank):
    """``chip_smoke``'s channel-parallel mesh parts on a (1, 2) mesh on the
    CPU: falcon-mamba-7b and recurrentgemma-2b at their reduced configs
    (each CONFIG swapped for REDUCED; the hybrid's prompts 80 and 72 past
    its reduced window of 64), the card's calls stubbed, failed checks
    collected."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import falcon_mamba_7b, recurrentgemma_2b
    for mod in (falcon_mamba_7b, recurrentgemma_2b):
        mod.CONFIG = mod.REDUCED
    failures = []
    chip_smoke.check = lambda ok, msg: ok or failures.append(msg)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    m, h = chip_smoke.MAMBA_ARCH, chip_smoke.HYBRID_ARCH
    chip_smoke.MESH_REC_CHECKS = ((m, 1, 24, 2), (h, 1, 80, 3))
    chip_smoke.MESH_REC_TRAIN = ((m, 2, 32, 2), (h, 1, 72, 3))
    chip_smoke.MESH_REC_GEN = ((m, 2, 24), (h, 5, 80))
    chip_smoke.MESH_REC_STEPS = 3
    mesh = _mesh(("data", "model"), (1, 2))
    return {"checks": [chip_smoke._mesh_rec_check(mesh, *c)
                       for c in chip_smoke.MESH_REC_CHECKS],
            "train": [chip_smoke._mesh_rec_train(mesh, *c)
                      for c in chip_smoke.MESH_REC_TRAIN],
            "gen": chip_smoke._mesh_rec_gen(mesh), "failures": failures}


def chip_audio_rank(rank):
    """``chip_smoke``'s audio and int8 mesh parts on a (1, 2) mesh on the
    CPU: whisper-base and h2o-danube-1.8b at their reduced configs (each
    CONFIG swapped for REDUCED; 40 frames, a 16-token decoder prompt; a
    96-token prompt past h2o's reduced window of 64, 2 layers), the
    card's calls stubbed, failed checks collected."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import h2o_danube_1_8b, whisper_base
    for mod in (h2o_danube_1_8b, whisper_base):
        mod.CONFIG = mod.REDUCED
    failures = []
    chip_smoke.check = lambda ok, msg: ok or failures.append(msg)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    chip_smoke.WHISPER_FRAMES, chip_smoke.WHISPER_PROMPT = 40, 16
    chip_smoke.WHISPER_STEPS = chip_smoke.MESH_REC_STEPS = 3
    chip_smoke.LM_PROMPT, chip_smoke.MESH_INT8_DEPTH = 96, 2
    mesh = _mesh(("data", "model"), (1, 2))
    return {"check": chip_smoke._mesh_audio_check(mesh),
            "gen": chip_smoke._mesh_audio_gen(mesh),
            "int8": chip_smoke._mesh_int8(mesh), "failures": failures}


# -------------------------------- KGE --------------------------------- #
def kge_rank(rank, cases, cfg_kw, triples, fit_steps):
    """Each case ``(name, make_model kwargs, init params, batches,
    rand_ents, corrupt_head)`` on a (2, 2) mesh: ``step_with`` over the
    given batches and negatives, the loss of each step and the params
    after the first, gathered; then ``init`` + ``fit`` for ``fit_steps``
    steps, its losses and final params."""
    from repro_torch.kge import make_model, params_from_numpy
    from repro_torch.kge.train import KGETrainer, TrainConfig
    mesh = _mesh(("data", "model"), (2, 2))
    out = {}
    for name, kw, init, batches, rands, sides in cases:
        n, n_rel, dim = kw["n"], kw["n_rel"], kw["dim"]
        model = make_model(name, n, n_rel, dim=dim, **kw["extra"])
        trainer = KGETrainer(model, TrainConfig(**cfg_kw), mesh=mesh)
        params = trainer.shard(params_from_numpy(model, init, "cpu"))
        opt = trainer.optimizer.init(params)
        losses, first = [], None
        for b, r, s in zip(batches, rands, sides):
            losses.append(float(trainer.train_step.step_with(
                params, opt, torch.from_numpy(b).long(),
                torch.from_numpy(r).long(), torch.from_numpy(s))))
            if first is None:
                first = {k: v.numpy() for k, v in
                         trainer.gather(params).items()}
        shards = {k: tuple(v.shape) for k, v in params.items()}
        params, _, stats = trainer.fit(triples, steps=fit_steps)
        out[kw["id"]] = {"losses": losses, "params1": first,
                         "shards": shards,
                         "fit_losses": [l for _, l in stats["losses"]],
                         "fit_params": {k: v.numpy() for k, v in
                                        trainer.gather(params).items()}}
    return out if rank == 0 else None
