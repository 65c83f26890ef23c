"""Step factories: train, prefill and greedy decode, and the dry run's
input specs.  The port of ``repro.models.steps``.  The params live in the
model, so the steps take none."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ..optim import Optimizer, OptState, adam
from . import runtime
from .layers import ParamTree
from .lm import BaseLM
from .sharding import batch_sharded, data_axes


def local_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global ``batch`` on a process mesh: a block
    of ``B / n_dp`` rows when the data axes divide B (the reference's
    ``batch_pspec``), else every row."""
    B = next(iter(batch.values())).shape[0]
    if not batch_sharded(mesh, B):
        return batch
    n = mesh.size // mesh.shape["model"]
    i = mesh.index(data_axes(mesh))
    return {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}


def loss_and_grads(model: BaseLM, batch, mesh=None):
    """``(loss, metrics, {name: grad})`` of ``model.loss`` on ``batch``,
    the params' ``.grad`` cleared after.  On a process ``mesh`` the params
    are this rank's share (``convert.shard_params``) and ``batch`` the
    global batch: the model runs on the rank's rows (:func:`local_batch`)
    under ``runtime.use_mesh``, so the loss is the global masked mean
    (``lm.xent``), and after ``backward()`` each gradient is summed over
    the data axes: a leaf cut over ``"model"`` has its share's gradient, a
    replicated one the same on every model rank (``runtime``'s
    collectives see to that)."""
    params = dict(model._p().named_parameters())
    with runtime.use_mesh(mesh):
        loss, metrics = model.loss(batch if mesh is None
                                   else local_batch(batch, mesh))
        loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    dp = None if mesh is None else runtime.data_group(mesh)
    if dp is not None:
        for g in grads.values():
            dist.all_reduce(g, group=dp)
    for p in params.values():
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: BaseLM, lr: float = 3e-4, mesh=None
                    ) -> Tuple[Callable, Optimizer]:
    """Returns (step, optimizer).  ``step(opt_state, batch) -> (opt_state,
    metrics)``: the loss and its gradients (:func:`loss_and_grads`, on a
    process ``mesh`` too), then Adam, in place, over
    ``dict(model.params.named_parameters())`` (the dict ``optimizer.init``
    takes; on a mesh the rank's share); ``metrics`` are the loss's with
    ``loss``.  Turns the params' gradients on."""
    optimizer = adam(lr)
    params = dict(model._p().requires_grad_(True).named_parameters())

    def step(opt_state: OptState, batch):
        loss, metrics, grads = loss_and_grads(model, batch, mesh)
        optimizer.update(grads, opt_state, params)
        return opt_state, dict(metrics, loss=loss)

    return step, optimizer


def _global_rows(x: torch.Tensor, mesh, B: int) -> torch.Tensor:
    """The global batch's rows of ``x`` from each data rank's (no
    gradient); ``x`` itself where the data axes do not cut the B rows."""
    dp = runtime.data_group(mesh)
    if dp is None or not batch_sharded(mesh, B):
        return x
    return runtime.gather_rows(x, dp)


def make_prefill_step(model: BaseLM, mesh=None) -> Callable:
    """step(batch, cache_len=None) -> (last logits (B, 1, V), cache).  On a
    process ``mesh`` the params are this rank's share
    (``convert.shard_params``) and ``batch`` the global batch: the
    prefill runs on the rank's rows (:func:`local_batch`) under
    ``runtime.use_mesh``; the logits are the global batch's, every
    ``padded_vocab`` column on every rank, the cache the rank's (its rows,
    its KV slots)."""
    def step(batch, cache_len=None):
        if mesh is None:
            return model.prefill(batch, cache_len=cache_len)
        with runtime.use_mesh(mesh):
            logits, cache = model.prefill(local_batch(batch, mesh),
                                          cache_len=cache_len)
        return _global_rows(logits, mesh,
                            next(iter(batch.values())).shape[0]), cache
    return step


def make_serve_step(model: BaseLM, mesh=None) -> Callable:
    """ONE new token against an existing cache. Greedy-samples so the
    output is a token, not raw logits: step(cache, token (B, 1), pos) ->
    (next_token (B, 1) int32, cache): the argmax of the logits, among tied
    logits the lower id.  On a process ``mesh`` (see
    :func:`make_prefill_step`) ``token`` and the next token are the global
    batch's, the same on every rank (the argmax of the gathered logits),
    and the cache is the rank's."""
    def step(cache, token: torch.Tensor, pos: int):
        if mesh is None:
            logits, cache = model.decode_step(cache, token, pos)
            return logits.argmax(-1).to(torch.int32), cache
        with runtime.use_mesh(mesh):
            logits, cache = model.decode_step(
                cache, local_batch({"token": token}, mesh)["token"], pos)
        return _global_rows(logits.argmax(-1).to(torch.int32), mesh,
                            token.shape[0]), cache
    return step


# --------------------------------------------------------------------- #
# dry-run input specs (meta tensors: shapes and dtypes, no memory)
# --------------------------------------------------------------------- #
def train_specs(model: BaseLM, global_batch: int, seq: int):
    """``(params, opt_state, batch)`` on the meta device: the param tree,
    Adam's state as ``make_train_step`` builds it (moments keyed by the
    params' dotted names; the step count as the 0-dim int32 the reference
    carries) and the batch."""
    params = model.param_tree(None)
    opt_state = adam(3e-4).init(dict(ParamTree(params).named_parameters()))
    opt_state.step = torch.empty((), dtype=torch.int32, device="meta")
    return params, opt_state, model.batch_spec(global_batch, seq)


def prefill_specs(model: BaseLM, global_batch: int, seq: int):
    return model.param_tree(None), model.batch_spec(global_batch, seq)


def serve_specs(model: BaseLM, global_batch: int, seq: int):
    """``(params, cache, token (B, 1) int32, pos () int32)``."""
    return (model.param_tree(None), model.cache_spec(global_batch, seq),
            torch.empty((global_batch, 1), dtype=torch.int32, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"))
