"""Carry the JAX package's LM params into the port's models.

The reference's params are a pytree of arrays: ``embed (V, d)``,
``layers`` (each leaf stacked on a leading ``(L, ...)`` axis, as
``stacked_init`` makes them), ``ln_f`` and ``lm_head (d, V)``.  The port
keeps the same keys and the same ``(d_in, d_out)`` weight layout, with
``layers`` (an encoder-decoder's ``enc_layers`` and ``dec_layers``) split
into one entry per layer; no leaf is transposed.  An MoE
layer's stacked ``moe.router (L, d, E)`` and ``moe.gate`` / ``moe.up``
``(L, E, d, ff)`` / ``moe.down (L, E, ff, d)`` split the same way.  The
hybrid's ``layers`` is ``{"periods": {"l0": ..., "l1": ..., "l2": ...},
"rem0": ..., "rem1": ...}``, each ``l{j}`` leaf stacked over the P
periods: period i's ``l{j}`` becomes layer ``3 i + j`` and ``rem{r}``
layer ``3 P + r``.

On a process mesh, :func:`shard_params` cuts a model's params to the
rank's share (``sharding.mesh_pspec``: the reference's ``param_pspec``,
the tensor-parallel layout of every family) and :func:`gather_params`
puts the shares back together; :func:`share_of` and :func:`whole_of` do
it for one leaf (a gradient too).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import runtime
from .layers import ParamTree
from .lm import BaseLM
from .sharding import check_tp, mesh_pspec


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _layer_leaves(name: str, group, n_layers: int) -> List[Dict[str, Any]]:
    """A stacked group of the reference's params as one flat dict of
    arrays a layer: every leaf split along its leading axis, or the
    hybrid's periods (each ``l{j}`` stacked over the periods) then its
    unstacked remainder."""
    if isinstance(group, Mapping) and "periods" in group:
        periods = group["periods"]
        period = len(periods)
        per_kind = [_flatten(periods[f"l{j}"]) for j in range(period)]
        n_periods = len(next(iter(per_kind[0].values())))
        layers = [{p: a[i] for p, a in per_kind[j].items()}
                  for i in range(n_periods) for j in range(period)]
        rem = len(group) - 1
        layers += [_flatten(group[f"rem{r}"]) for r in range(rem)]
        if len(layers) != n_layers:
            raise ValueError(f"{name}: {n_periods} periods of {period} and "
                             f"{rem} more layers, want {n_layers} layers")
        return layers
    flat = _flatten(group)
    for p, a in flat.items():
        shape = np.shape(a)
        if not shape or shape[0] != n_layers:
            raise ValueError(f"{name}: param {p} has shape {shape}, want a "
                             f"leading axis of {n_layers} layers")
    return [{p: a[i] for p, a in flat.items()} for i in range(n_layers)]


def params_from_numpy(model: BaseLM, tree: Mapping,
                      device: DeviceLike = None) -> BaseLM:
    """Fill ``model.params`` from the JAX package's params ``tree`` (numpy
    arrays or anything ``np.asarray`` takes), cast to the model's dtype, on
    ``device`` (default ``cuda``).  Every stacked group of layers (a list
    in the model's param tree: ``layers``, or an encoder-decoder's
    ``enc_layers`` and ``dec_layers``) splits along its leading axis (the
    hybrid's periods and remainder map as the module says).  Raises ``KeyError`` on a missing or an extra leaf and ``ValueError`` on
    a shape that differs from the model's.  Returns the model."""
    dev = resolve_device(device)
    arch = model.cfg.arch_id
    want = model.param_tree(None)              # meta tensors: shapes, dtypes
    stacks = [k for k, v in want.items() if isinstance(v, list)]
    got = dict(tree)
    pairs = [("", _flatten({k: v for k, v in want.items()
                            if k not in stacks}),
              _flatten({k: v for k, v in got.items() if k not in stacks}))]
    layers = {g: _layer_leaves(f"{arch} {g}", got.get(g, {}), len(want[g]))
              for g in stacks}
    for g in stacks:
        pairs += [(f"{g}[{i}].", _flatten(w), got_i)
                  for i, (w, got_i) in enumerate(zip(want[g], layers[g]))]
    for kind, w, g in pairs:
        missing = sorted(set(w) - set(g))
        extra = sorted(set(g) - set(w))
        if missing or extra:
            raise KeyError(f"{arch}: param leaves differ from the model's: "
                           f"missing {[kind + m for m in missing]}, extra "
                           f"{[kind + e for e in extra]}")

    def tensor(path: str, a, like: torch.Tensor) -> torch.Tensor:
        a = np.asarray(a, dtype=np.float32)   # bf16 leaves arrive as ml_dtypes
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{arch}: param {path} has shape "
                             f"{tuple(a.shape)}, the model {tuple(like.shape)}")
        # a copy: the model never shares memory with the caller's arrays
        return torch.tensor(a, dtype=like.dtype, device=dev)

    _, want_top, got_top = pairs[0]
    params = _unflatten({p: tensor(p, got_top[p], like)
                         for p, like in want_top.items()})
    for g in stacks:
        params[g] = [
            _unflatten({p: tensor(f"{g}[{i}].{p}", got_i[p], like)
                        for p, like in _flatten(w).items()})
            for i, (w, got_i) in enumerate(zip(want[g], layers[g]))]
    model.params = ParamTree(params)
    return model


def _leaves(model: BaseLM):
    """``(dotted name, owning module, leaf name, tensor)`` of every param."""
    for name, t in list(model._p().named_parameters()):
        parent, _, leaf = name.rpartition(".")
        yield name, model.params.get_submodule(parent), leaf, t


def _layout(cfg, name: str, ndim: int, mesh):
    """``(spec, halves)`` of the leaf ``name``: its ``sharding.mesh_pspec``,
    and whether its last dim is two halves each cut by the spec (mamba's
    fused ``in_proj``, ``xi | z``: a rank holds its block of each)."""
    path = tuple(name.split("."))
    spec = mesh_pspec(cfg, path, ndim, mesh.shape["model"])
    return spec, cfg.family == "ssm" and path[-2:] == ("in_proj", "w")


def share_of(cfg, name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of the full leaf ``t`` named ``name`` (a param or
    its gradient), as a new tensor."""
    spec, halves = _layout(cfg, name, t.dim(), mesh)
    if halves:
        return runtime.take_share(t.unflatten(-1, (2, -1)),
                                  spec[:-1] + (None,) + spec[-1:],
                                  mesh).flatten(-2)
    return runtime.take_share(t, spec, mesh)


def whole_of(cfg, name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """The full leaf ``name`` from every rank's share ``t`` (collective
    over the world): :func:`share_of` undone."""
    spec, halves = _layout(cfg, name, t.dim(), mesh)
    if halves:
        return runtime.gather_share(t.unflatten(-1, (2, -1)),
                                    spec[:-1] + (None,) + spec[-1:],
                                    mesh).flatten(-2)
    return runtime.gather_share(t, spec, mesh)


def shard_params(model: BaseLM, mesh) -> BaseLM:
    """Cut ``model.params`` in place to this rank's share on the process
    ``mesh`` (``sharding.mesh_pspec``, :func:`share_of`: an audio
    model's tied ``embed`` by vocab rows); each cut leaf is a new tensor,
    so the full one is freed leaf by leaf.  Raises ``ValueError`` (from
    ``sharding.check_tp``) on a config the model axis cannot cut.
    Returns the model."""
    check_tp(model.cfg, mesh.shape["model"])
    for name, mod, leaf, t in _leaves(model):
        if any(_layout(model.cfg, name, t.dim(), mesh)[0]):
            setattr(mod, leaf, torch.nn.Parameter(
                share_of(model.cfg, name, t.detach(), mesh),
                requires_grad=t.requires_grad))
    return model


def gather_params(model: BaseLM, mesh) -> Dict[str, torch.Tensor]:
    """``{dotted name: full tensor}`` from every rank's share (collective
    over the world)."""
    return {name: whole_of(model.cfg, name, t.detach(), mesh)
            for name, _, _, t in _leaves(model)}
