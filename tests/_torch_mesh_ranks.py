"""The functions each rank of the port's process worlds runs in
``tests/test_torch_runtime.py``, ``test_torch_mesh_moe.py``,
``test_torch_seq_shard.py`` and ``test_torch_kge_mesh.py``.

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
    from repro_torch.models import runtime
    from repro_torch.models.sharding import expert_parallel_pspec
    return {n: runtime.gather_share(
        g, expert_parallel_pspec(cfg, tuple(n.split(".")), g.dim()),
        mesh).numpy() for n, g in grads.items()}


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
    from repro_torch.models.sharding import expert_parallel_pspec
    mesh = _mesh(("data", "model"), (1, 2))
    cfg = get_config("olmoe_1b_7b", reduced=True).with_(
        moe_impl="shard_map", **cfg_kw)
    p = {k: runtime.take_share(
        torch.from_numpy(v).to(cfg.jdtype),
        expert_parallel_pspec(cfg, ("moe", k), v.ndim), mesh)
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
    tree) on a (2, 2) mesh with and without ``seq_shard``: loss, every
    gradient leaf and the residual rows each checkpointed block was given
    (what remat keeps); and the error for a sequence the model axis does
    not divide."""
    from repro_torch.models import build, get_config, lm
    from repro_torch.models.convert import params_from_numpy
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
            model = params_from_numpy(build(cfg), params, "cpu")
            model._p().requires_grad_(True)
            saved.clear()
            loss, _, grads = loss_and_grads(model, batch, mesh)
            out[seq] = {"loss": float(loss), "saved": list(saved),
                        "grads": {n: g.numpy() for n, g in grads.items()}}
        odd = {k: v[:, :-1] for k, v in batch.items()}
        try:
            loss_and_grads(model, odd, mesh)
            out["odd"] = None
        except ValueError as e:
            out["odd"] = str(e)
    finally:
        lm.checkpoint = real
    return out if rank == 0 else None


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
