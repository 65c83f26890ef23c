"""Fused KGE scoring: the wrapper around ``csrc/kge_score.cu``.

The port of ``repro.kernels.kge_score.kge_score_pallas``, plus the
backward the JAX package leaves to autodiff.  The forward scores B
positives ``(h, r, t)`` and their K negatives (``neg`` replaces the head
where ``corrupt_head`` is true, the tail elsewhere) for TransE-L1,
TransE-L2 or DistMult; the backward takes the cotangents of both outputs
and returns the gradients of all four embedding operands.  The contracts
are :func:`repro_torch.kernels.ref.kge_score_ref` and
:func:`repro_torch.kernels.ref.kge_score_backward_ref`.

On CPU tensors the plain PyTorch versions run.  On CUDA tensors the
kernels run or the call raises: there is no switch and no fallback.  Any
B >= 1 and K >= 1 is taken as it is (no padding).  ``launches`` counts the
kernel launches of each C entry point.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

#: largest d (the forward's three rows of d floats, the backward's stage
#: of at least one row of d floats: 48 KB of shared memory)
MAX_DIM = 4096
#: largest K the wrapper takes (the backward streams any slab in chunks
#: of rows)
MAX_NEGS = 8192

# Both entry points take their arguments packed (``_build.Library``):
#   forward:  h, r, t, neg, ch, B, K, d, model, pos, negs, stream
#   backward: h, r, t, neg, ch, g_pos, g_negs, B, K, d, model, gh, gr, gt,
#             gneg, stream
_LIB = _build.Library("kge_score", {"kge_score_forward": 12,
                                    "kge_score_backward": 16})
#: kernel launches per C entry point since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset
_MODEL_IDS = {m: i for i, m in enumerate(ref.KGE_MODELS)}
_F32 = torch.float32
_MASK_DTYPES = (torch.bool, torch.uint8)


def _model_id(model: str) -> int:
    mid = _MODEL_IDS.get(model)
    if mid is None:
        raise ValueError(f"unknown kge_score model {model!r}; have "
                         f"{ref.KGE_MODELS}")
    return mid


def _check(h, r, t, neg, corrupt_head) -> Tuple[int, int, int]:
    """``(B, K, d)``; raises ``ValueError`` on anything the kernels do not
    take.  Each tensor's metadata is read once; the detailed message is
    only built for a tensor that fails."""
    hs, ns = h.shape, neg.shape
    if len(hs) != 2:
        raise ValueError(f"h must be (B, d), got {tuple(hs)}")
    b, d = hs
    if b < 1 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"need B >= 1 and 1 <= d <= {MAX_DIM}, got "
                         f"{tuple(hs)}")
    if len(ns) != 3 or ns[0] != b or ns[2] != d:
        raise ValueError(f"neg must be ({b}, K, {d}), got {tuple(ns)}")
    k = ns[1]
    if not 1 <= k <= MAX_NEGS:
        raise ValueError(f"need 1 <= K <= {MAX_NEGS}, got {k}")
    dev = h.device
    for name, x, shape in (("h", h, hs), ("r", r, hs), ("t", t, hs),
                           ("neg", neg, ns)):
        if x.dtype is not _F32 or x.shape != shape \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{tuple(shape)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if corrupt_head.dtype not in _MASK_DTYPES \
            or corrupt_head.shape != (b, k) \
            or not corrupt_head.is_contiguous() or corrupt_head.device != dev:
        raise ValueError(f"corrupt_head must be contiguous bool or uint8 "
                         f"({b}, {k}) on {dev}, got {corrupt_head.dtype} "
                         f"{tuple(corrupt_head.shape)} on "
                         f"{corrupt_head.device}")
    return b, k, d


def forward_outputs(b: int, k: int, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``pos (B,)`` and ``negs (B, K)``, float32.  Two allocations, sizes
    passed as ints: on an H100 they measured less host time than one
    buffer and two views of it, or sizes passed as tuples (PERF.md)."""
    return (torch.empty(b, dtype=_F32, device=device),
            torch.empty(b, k, dtype=_F32, device=device))


def kge_score_forward(h: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
                      neg: torch.Tensor, corrupt_head: torch.Tensor,
                      model: str = "transe_l1"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos (B,), negs (B, K))`` float32 scores, higher is better."""
    mid = _model_id(model)
    dev = h.device
    if dev.type == "cpu":
        return ref.kge_score_ref(h, r, t, neg, corrupt_head, model)
    b, k, d = _check(h, r, t, neg, corrupt_head)
    with _build.on_device(dev):
        pos, negs = forward_outputs(b, k, dev)
        _LIB.launch("kge_score_forward", h.data_ptr(), r.data_ptr(),
                    t.data_ptr(), neg.data_ptr(), corrupt_head.data_ptr(), b,
                    k, d, mid, pos.data_ptr(), negs.data_ptr(),
                    _build.stream_handle(dev))
    return pos, negs


def kge_score_backward(h: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
                       neg: torch.Tensor, corrupt_head: torch.Tensor,
                       g_pos: torch.Tensor, g_negs: torch.Tensor,
                       model: str = "transe_l1"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """``(grad_h, grad_r, grad_t (B, d), grad_neg (B, K, d))`` for the
    cotangents ``g_pos (B,)`` and ``g_negs (B, K)``."""
    mid = _model_id(model)
    dev = h.device
    if dev.type == "cpu":
        return ref.kge_score_backward_ref(h, r, t, neg, corrupt_head, g_pos,
                                          g_negs, model)
    b, k, d = _check(h, r, t, neg, corrupt_head)
    for name, g, shape in (("g_pos", g_pos, (b,)), ("g_negs", g_negs, (b, k))):
        if g.dtype is not _F32 or g.shape != shape \
                or not g.is_contiguous() or g.device != dev:
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{dev}, got {g.dtype} {tuple(g.shape)} on "
                             f"{g.device}")
    with _build.on_device(dev):
        gh = torch.empty_like(h)
        gr = torch.empty_like(r)
        gt = torch.empty_like(t)
        gneg = torch.empty_like(neg)
        _LIB.launch("kge_score_backward", h.data_ptr(), r.data_ptr(),
                    t.data_ptr(), neg.data_ptr(), corrupt_head.data_ptr(),
                    g_pos.data_ptr(), g_negs.data_ptr(), b, k, d, mid,
                    gh.data_ptr(), gr.data_ptr(), gt.data_ptr(),
                    gneg.data_ptr(), _build.stream_handle(dev))
    return gh, gr, gt, gneg
