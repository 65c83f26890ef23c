"""Runtime context the model functions cannot carry in configs: the
active process mesh, and the collectives the mesh branches use.  The port
of ``repro.models.runtime``.

:func:`use_mesh` sets a ``launch.mesh.ProcessMesh`` around a forward
(``models.steps``, chip_smoke's mesh phase); ``None`` (the default) is a
single-process run.  Under a mesh ``blocks.moe_dispatch`` takes the
expert-parallel MoE when the config asks for it, ``dense.DenseLM``
sequence-shards its residual, and ``lm.xent`` reduces over the data axes.

Under a mesh whose ``"model"`` axis is past size 1, the families of
``sharding.TP_FAMILIES`` (dense, VLM, MoE, SSM, hybrid, audio) run
tensor-parallel on the rank's share of their weights
(``models.sharding.mesh_pspec``, the reference's ``param_pspec``):
:func:`tp_group` gives the model code that axis's group.

The reference's ``shard_map`` types each value as invariant or varying
over a mesh axis and transposes its collectives by those types.  Here
every rank runs the model on its own tensors and autograd differentiates
each rank's copy; each function below carries its reference counterpart's
forward and the backward that reference's transpose gives:

  * :func:`psum_identity_bwd` — ``all_reduce`` sum forward, identity
    backward (``_psum_identity_bwd``): right when every rank of the group
    computes identically downstream, so the cotangent is already the
    same on each;
  * :func:`pvary` — identity forward, ``all_reduce`` sum of the
    cotangent backward: an invariant value (the tokens, the router) used
    by rank-local work whose cotangents are partial sums (``_pvary`` and
    the implicit broadcast of an invariant operand);
  * :func:`pmean` — mean forward, cotangent / n backward
    (``jax.lax.pmean`` of a varying value read as invariant);
  * :func:`gather_seq` / :func:`slice_seq` — all-gather along the
    sequence dim and take this rank's block of it, each the other's
    backward (the sequence-sharded residual: the blocks compute
    replicated over the group, so a gathered cotangent is the same on
    every rank and its transpose is a slice, not a reduce-scatter);
  * :func:`gather_last` — all-gather along the last dim, backward this
    rank's block (the embedding's d columns, the vocab-sharded logits:
    what reads them computes replicated over the group, so the cotangent
    is the same on every rank);
  * :func:`gather_last_summed` — all-gather along the last dim, backward
    the sum of the ranks' cotangents, this rank's block of it (a
    reduce-scatter: the projected K / V where ``n_kv_heads`` is not a
    multiple of the group's size, which each rank reads for other slots).

Gradients of params replicated over the data axes are summed over them
after ``backward()`` (``steps.make_train_step``); the losses are built so
that the sum is the global gradient.
"""
from __future__ import annotations

import contextlib
import itertools

import torch
import torch.distributed as dist

from .sharding import TP_FAMILIES

_MESH = None


def get_mesh():
    """The active ``ProcessMesh``, or None."""
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (or None) the active mesh; the previous one is back on
    exit, also on an exception."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def tp_group(cfg):
    """The group of the active mesh's ``"model"`` axis when it cuts
    ``cfg``'s weights (a family of ``sharding.TP_FAMILIES``, an axis past
    size 1), else None."""
    if _MESH is None or _MESH.shape["model"] == 1 \
            or cfg.family not in TP_FAMILIES:
        return None
    return _MESH.group("model")


def group_index(group):
    """``(size, this rank's index)`` of ``group``."""
    return dist.get_world_size(group), dist.get_group_rank(
        group, dist.get_rank())


def data_group(mesh):
    """The group of the mesh's data axes (``"pod"`` and ``"data"``), or
    None when it has neither."""
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return mesh.group(dp) if dp else None


class _PsumIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def psum_identity_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``; the backward is the identity."""
    return _PsumIdentityBwd.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; the backward sums the cotangent over ``group``."""
    return _Pvary.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over ``group``; the backward divides by its size."""
    return _Pmean.apply(x, group)


def row_lookup(table: torch.Tensor, ids: torch.Tensor, group
               ) -> torch.Tensor:
    """Rows ``ids`` (global, any shape) of a table cut by rows over
    ``group``, ``table`` this rank's block: a masked gather of the rank's
    rows summed over the group (one ``all_reduce``), whose backward
    reaches the rank's own rows only (the reference's vocab-parallel
    lookup: the KGE trainer's tables, an encoder-decoder's tied embed)."""
    n = table.shape[0]
    local = ids - group_index(group)[1] * n
    mine = (local >= 0) & (local < n)
    rows = table.index_select(0, torch.where(mine, local, 0).reshape(-1))
    rows = rows.reshape(ids.shape + table.shape[1:]) * mine.view(
        mine.shape + (1,) * (table.dim() - 1)).to(rows.dtype)
    return psum_identity_bwd(rows, group)


def _block(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``group`` along ``dim`` (the sequence's: 1)."""
    n, i = group_index(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {n} blocks")
    return x.chunk(n, dim)[i].contiguous()


def _gather_parts(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` of ``group`` (None: the world), in rank order:
    the one gather of this module (gloo gathers CUDA tensors too)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along dim 0, no
    gradient (the serving steps' rows over the data axes)."""
    return torch.cat(_gather_parts(x, group), 0)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(_gather_parts(x, group), 1)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group), None


class _SliceSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather_parts(g, ctx.group), 1), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, summed):
        ctx.group, ctx.summed = group, summed
        return torch.cat(_gather_parts(x, group), -1)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = g.contiguous()
            dist.all_reduce(g, group=ctx.group)
        return _block(g, ctx.group, -1), None, None


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along the last dim; the
    backward takes this rank's block of the cotangent."""
    return _GatherLast.apply(x, group, False)


def gather_last_summed(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_last` whose backward sums the cotangent over
    ``group`` before it takes this rank's block."""
    return _GatherLast.apply(x, group, True)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along the sequence dim
    (1), in rank order; the backward takes this rank's block of the
    cotangent."""
    return _GatherSeq.apply(x, group)


def slice_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``x`` along the sequence dim (1: its length
    over the group's size); the backward all-gathers the cotangent."""
    return _SliceSeq.apply(x, group)


# --------------------------------------------------------------------- #
# a rank's share of a tensor laid out by a spec
# --------------------------------------------------------------------- #
def _dim_axes(spec, i: int):
    entry = spec[i] if i < len(spec) else None
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def take_share(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` laid out by ``spec``
    (``models.sharding``'s tuples) on ``mesh``, as a new tensor."""
    out = x
    for i in range(x.dim()):
        axes = _dim_axes(spec, i)
        if axes:
            n = mesh.axis_size(axes)
            if x.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(x.shape)} does not "
                                 f"divide into {n} parts ({spec})")
            out = out.chunk(n, i)[mesh.index(axes)]
    return out.clone()


def gather_share(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's share ``x`` laid out by ``spec``
    (collective over the world): the shares are all-gathered and each is
    put at its block.  A dim replicated over an axis is taken once, from
    the ranks at coordinate 0 of the axes ``spec`` does not name."""
    axes = [_dim_axes(spec, i) for i in range(x.dim())]
    sharded = {a for ax in axes for a in ax}
    out = x.new_empty([x.shape[i] * (mesh.axis_size(ax) if ax else 1)
                       for i, ax in enumerate(axes)])
    positions = itertools.product(*(range(s) for s in mesh.sizes))
    for coords, part in zip(positions, _gather_parts(x, None)):
        if any(c for c, a in zip(coords, mesh.axis_names)
               if a not in sharded):
            continue
        out[tuple(slice(j * n, (j + 1) * n) for j, n in (
            (mesh.index(ax, coords) if ax else 0, x.shape[i])
            for i, ax in enumerate(axes)))] = part
    return out
