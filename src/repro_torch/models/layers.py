"""Shared transformer building blocks: the port of ``repro.models.layers``.

Parameters are held in :class:`ParamTree` modules whose keys are those of
the JAX package's param dicts (``p["wq"]["w"]``), so the same code reads
both and ``models/convert.py`` carries one into the other leaf by leaf.
Dense weights keep the reference's ``(d_in, d_out)`` layout (``y = x @ w``).
Initialisers draw from an explicit ``torch.Generator``, on its device; given
``None`` they build tensors on the meta device: the shapes and dtypes of the
params without their memory (what ``models/convert.py`` checks against).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import runtime


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dicts become submodules, lists
    ``nn.ModuleList``s, tensors frozen ``nn.Parameter``s.  ``p["k"]`` and
    ``"k" in p`` read it as the JAX package's dicts are read.

    Serving needs no gradients, so every leaf starts frozen; training turns
    them on with ``requires_grad_(True)`` (``steps.make_train_step`` does),
    and ``named_parameters()`` gives the leaves by dotted path
    (``layers.0.attn.wq.w``)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name not in self:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
Gen = Optional[torch.Generator]


def init_device(gen: Gen) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def normal(gen: Gen, shape, scale: float, dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in fp32, stored in ``dtype``; scaled in
    place, so a leaf's draw holds one fp32 transient."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def dense_init(gen: Gen, d_in: int, d_out: int, dtype,
               bias: bool = False) -> dict:
    p = {"w": normal(gen, (d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=init_device(gen))
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in x's dtype (fp32 accumulation inside the GEMM)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def row_dense(p, x: torch.Tensor, group=None) -> torch.Tensor:
    """``dense`` of a weight whose rows (its input) a process ``group``
    cuts: ``x @ w`` summed over the group (one ``all_reduce``,
    ``runtime.psum_identity_bwd``), the bias added once after."""
    y = x @ p["w"]
    if group is not None:
        y = runtime.psum_identity_bwd(y, group)
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(gen: Gen, d: int, dtype, kind: str = "rmsnorm") -> dict:
    dev = init_device(gen)
    p = {"scale": torch.ones((d,), dtype=dtype, device=dev)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def apply_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm where ``p`` has a bias; computed in fp32."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    ms = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #
def mlp_init(gen: Gen, d: int, ff: int, dtype,
             act: str = "swiglu") -> dict:
    p = {"up": dense_init(gen, d, ff, dtype),
         "down": dense_init(gen, ff, d, dtype)}
    if act == "swiglu":
        p["gate"] = dense_init(gen, d, ff, dtype)
    return p


def mlp(p, x: torch.Tensor, act: str = "swiglu",
        group=None) -> torch.Tensor:
    """With a process ``group`` (``runtime.tp_group``) ``gate`` / ``up``
    hold the rank's ff columns and ``down`` its ff rows: x enters through
    ``runtime.pvary`` and ``down`` is :func:`row_dense`."""
    if group is not None:
        x = runtime.pvary(x, group)
    if act == "swiglu":
        h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(p["up"], x), approximate="tanh")
    return row_dense(p["down"], h, group)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rope_rotate(x: torch.Tensor, pos: torch.Tensor, theta: float,
                 head_axes: int) -> torch.Tensor:
    """Rotate the trailing hd axis of x by position-dependent angles.

    Pairs are interleaved, ``(x[..., 0::2], x[..., 1::2])``, as in the
    reference (not the half-split layout of most PyTorch code).

    x:   (B, S, <head_axes dims>, hd)
    pos: (S,) or (B, S)
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    p = pos if pos.dim() == 2 else pos[None, :]            # (B|1, S)
    ang = p[..., None].float() * freqs                     # (B|1, S, hd/2)
    ang = ang.reshape(ang.shape[:2] + (1,) * head_axes + ang.shape[-1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return o.reshape(x.shape).to(x.dtype)


def rope_qk(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
            k_pos: torch.Tensor, theta: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, G, H, hd); k: (B, Sk, G, hd)."""
    return (_rope_rotate(q, q_pos, theta, head_axes=2),
            _rope_rotate(k, k_pos, theta, head_axes=1))
