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

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build, ref

#: largest d (three rows of d floats in 48 KB of shared memory)
MAX_DIM = 4096
#: largest K (K + 1 floats and K flags in 48 KB of shared memory)
MAX_NEGS = 8192

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # h, r, t, neg, ch, B, K, d, model, pos, negs, stream
    "kge_score_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # h, r, t, neg, ch, g_pos, g_negs, B, K, d, model, gh, gr, gt, gneg,
    # stream
    "kge_score_backward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P),
}

#: kernel launches per C entry point since the last reset_launches()
launches = {name: 0 for name in _SIGNATURES}
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("kge_score")
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _launch(name: str, *args) -> None:
    rc = getattr(_library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    with _count_lock:
        launches[name] += 1


def _model_id(model: str) -> int:
    if model not in ref.KGE_MODELS:
        raise ValueError(f"unknown kge_score model {model!r}; have "
                         f"{ref.KGE_MODELS}")
    return ref.KGE_MODELS.index(model)


def _check(h, r, t, neg, corrupt_head) -> Tuple[int, int, int]:
    dev = h.device
    if h.dim() != 2:
        raise ValueError(f"h must be (B, d), got {tuple(h.shape)}")
    b, d = h.shape
    if b < 1 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"need B >= 1 and 1 <= d <= {MAX_DIM}, got "
                         f"{tuple(h.shape)}")
    if neg.dim() != 3 or neg.shape[0] != b or neg.shape[2] != d:
        raise ValueError(f"neg must be ({b}, K, {d}), got {tuple(neg.shape)}")
    k = neg.shape[1]
    if not 1 <= k <= MAX_NEGS:
        raise ValueError(f"need 1 <= K <= {MAX_NEGS}, got {k}")
    for name, x, shape in (("h", h, (b, d)), ("r", r, (b, d)),
                           ("t", t, (b, d)), ("neg", neg, (b, k, d))):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if corrupt_head.device != dev \
            or corrupt_head.dtype not in (torch.bool, torch.uint8) \
            or tuple(corrupt_head.shape) != (b, k) \
            or not corrupt_head.is_contiguous():
        raise ValueError(f"corrupt_head must be contiguous bool or uint8 "
                         f"({b}, {k}) on {dev}, got {corrupt_head.dtype} "
                         f"{tuple(corrupt_head.shape)} on "
                         f"{corrupt_head.device}")
    return b, k, d


def kge_score_forward(h: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
                      neg: torch.Tensor, corrupt_head: torch.Tensor,
                      model: str = "transe_l1"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos (B,), negs (B, K))`` float32 scores, higher is better."""
    mid = _model_id(model)
    if h.device.type == "cpu":
        return ref.kge_score_ref(h, r, t, neg, corrupt_head, model)
    b, k, d = _check(h, r, t, neg, corrupt_head)
    with torch.cuda.device(h.device):
        pos = torch.empty((b,), dtype=torch.float32, device=h.device)
        negs = torch.empty((b, k), dtype=torch.float32, device=h.device)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _launch("kge_score_forward", h.data_ptr(), r.data_ptr(),
                t.data_ptr(), neg.data_ptr(), corrupt_head.data_ptr(), b, k,
                d, mid, pos.data_ptr(), negs.data_ptr(), stream)
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
    if h.device.type == "cpu":
        return ref.kge_score_backward_ref(h, r, t, neg, corrupt_head, g_pos,
                                          g_negs, model)
    b, k, d = _check(h, r, t, neg, corrupt_head)
    for name, g, shape in (("g_pos", g_pos, (b,)), ("g_negs", g_negs, (b, k))):
        if g.device != h.device or g.dtype != torch.float32 \
                or tuple(g.shape) != shape or not g.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{h.device}, got {g.dtype} {tuple(g.shape)} on "
                             f"{g.device}")
    with torch.cuda.device(h.device):
        gh = torch.empty_like(h)
        gr = torch.empty_like(r)
        gt = torch.empty_like(t)
        gneg = torch.empty_like(neg)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _launch("kge_score_backward", h.data_ptr(), r.data_ptr(),
                t.data_ptr(), neg.data_ptr(), corrupt_head.data_ptr(),
                g_pos.data_ptr(), g_negs.data_ptr(), b, k, d, mid,
                gh.data_ptr(), gr.data_ptr(), gt.data_ptr(), gneg.data_ptr(),
                stream)
    return gh, gr, gt, gneg
