"""Carry the JAX package's LM params into the port's models.

The reference's params are a pytree of arrays: ``embed (V, d)``,
``layers`` (each leaf stacked on a leading ``(L, ...)`` axis, as
``stacked_init`` makes them), ``ln_f`` and ``lm_head (d, V)``.  The port
keeps the same keys and the same ``(d_in, d_out)`` weight layout, with
``layers`` (an encoder-decoder's ``enc_layers`` and ``dec_layers``) split
into one entry per layer; no leaf is transposed.  An MoE
layer's stacked ``moe.router (L, d, E)`` and ``moe.gate`` / ``moe.up``
``(L, E, d, ff)`` / ``moe.down (L, E, ff, d)`` split the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .layers import ParamTree
from .lm import BaseLM


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


def params_from_numpy(model: BaseLM, tree: Mapping,
                      device: DeviceLike = None) -> BaseLM:
    """Fill ``model.params`` from the JAX package's params ``tree`` (numpy
    arrays or anything ``np.asarray`` takes), cast to the model's dtype, on
    ``device`` (default ``cuda``).  Every stacked group of layers (a list
    in the model's param tree: ``layers``, or an encoder-decoder's
    ``enc_layers`` and ``dec_layers``) splits along its leading axis.
    Raises ``KeyError`` on a missing or an extra leaf and ``ValueError`` on
    a shape that differs from the model's.  Returns the model."""
    dev = resolve_device(device)
    want = model.param_tree(None)              # meta tensors: shapes, dtypes
    stacks = [k for k, v in want.items() if isinstance(v, list)]
    got = dict(tree)
    pairs = [("", _flatten({k: v for k, v in want.items()
                            if k not in stacks}),
              _flatten({k: v for k, v in got.items() if k not in stacks}))]
    for g in stacks:
        pairs.append((f"{g}.", _flatten(want[g][0]) if want[g] else {},
                      _flatten(got.get(g, {}))))
    for kind, w, g in pairs:
        missing = sorted(set(w) - set(g))
        extra = sorted(set(g) - set(w))
        if missing or extra:
            raise KeyError(f"{model.cfg.arch_id}: param leaves differ from "
                           f"the model's: missing {[kind + m for m in missing]},"
                           f" extra {[kind + e for e in extra]}")

    def tensor(path: str, a, like: torch.Tensor) -> torch.Tensor:
        a = np.asarray(a, dtype=np.float32)   # bf16 leaves arrive as ml_dtypes
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{model.cfg.arch_id}: param {path} has shape "
                             f"{tuple(a.shape)}, the model {tuple(like.shape)}")
        # a copy: the model never shares memory with the caller's arrays
        return torch.tensor(a, dtype=like.dtype, device=dev)

    _, want_top, got_top = pairs[0]
    params = _unflatten({p: tensor(p, got_top[p], like)
                         for p, like in want_top.items()})
    for g, (_, want_layer, got_layer) in zip(stacks, pairs[1:]):
        n_layers = len(want[g])
        per_layer = [{} for _ in range(n_layers)]
        for p, like in want_layer.items():
            stacked = np.asarray(got_layer[p])
            if stacked.ndim == 0 or stacked.shape[0] != n_layers:
                raise ValueError(f"{model.cfg.arch_id}: param {g}.{p} has "
                                 f"shape {stacked.shape}, want a leading axis "
                                 f"of {n_layers} layers")
            for i in range(n_layers):
                per_layer[i][p] = tensor(f"{g}.{p}[{i}]", stacked[i], like)
        params[g] = [_unflatten(one) for one in per_layer]
    model.params = ParamTree(params)
    return model
