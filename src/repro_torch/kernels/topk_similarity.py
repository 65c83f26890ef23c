"""Fused cosine top-k: the wrapper around ``csrc/topk_cosine.cu``.

The port of ``repro.kernels.topk_similarity.topk_cosine_pallas`` (and of
the merge step of ``repro.kernels.ops._topk_stream``).  One call is one
*slab step*: score a ``(rows, d)`` slab of table rows against row-
normalized queries and merge it into a running ``(Q, k)`` top-k.  The
contract is :func:`repro_torch.kernels.ref.stream_step_ref`:

  * score ``q . (e / max(norm, 1e-12))`` in fp32 (``norms`` optional);
  * columns ``>= limit`` and each query's ``exclude_rows`` column score
    ``-1e30``;
  * order by score descending, then by global index ascending.

On a CPU tensor the plain PyTorch version runs.  On a CUDA tensor the
kernel runs or the call raises: there is no switch and no fallback.
k <= 64 (the paper's k = 10) takes two launches, per-chunk selection and
a merge; larger k builds one 64-bit key per candidate and sorts them with
a bitonic network (several launches).

``launches`` counts the kernel launches of each C entry point; a run
resets it and reads it to show that the main path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build, ref

#: largest k served by the two-launch select/merge path
SMALL_K_MAX = 64
#: rows per scoring block (CHUNK in topk_cosine.cu)
CHUNK_ROWS = 256
#: keys per shared-memory bitonic tile (SORT_TILE in topk_cosine.cu)
SORT_TILE = 2048

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, Q, d, tbl, stride, rows, norms, excl, offset, limit, kc, cand, stream
    "topk_select_chunks": (_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                           _P),
    # run_s, run_i, k_run, cand, n_cand, Q, k, out_s, out_i, stream
    "topk_merge_running": (_P, _P, _I, _P, _I, _I, _I, _P, _P, _P),
    # q, Q, d, tbl, stride, rows, norms, excl, offset, limit,
    # run_s, run_i, k_run, keys, P, stream
    "topk_score_keys": (_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                        _P, _I, _P),
    # keys, Q, P, size, stride, stream
    "topk_bitonic_global": (_P, _I, _I, _I, _I, _P),
    # keys, Q, P, size_lo, size_hi, stream
    "topk_bitonic_shared": (_P, _I, _I, _I, _I, _P),
    # keys, Q, P, k, out_s, out_i, stream
    "topk_gather": (_P, _I, _I, _I, _P, _P, _P),
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
            lib = _build.load("topk_cosine")
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def bitonic_schedule(P: int):
    """The launches that sort rows of ``P`` keys (a power of two):
    ``("shared", size_lo, size_hi)`` runs stages size_lo..size_hi for all
    strides inside one tile, ``("global", size, stride)`` one wide-stride
    pass.  Kept in Python so the CPU tests can check the network."""
    tile = min(SORT_TILE, P)
    steps = [("shared", 2, tile)]
    size = 2 * tile
    while size <= P:
        stride = size // 2
        while stride >= tile:
            steps.append(("global", size, stride))
            stride //= 2
        steps.append(("shared", size, size))
        size *= 2
    return steps


def _check(q, blk, norms, excl, offset, limit, k, run_s, run_i) -> None:
    dev = blk.device
    if blk.dtype != torch.float32 or blk.dim() != 2 or blk.stride(1) != 1:
        raise ValueError("table slab must be float32 (rows, d) with "
                         f"unit column stride, got {blk.dtype} "
                         f"{tuple(blk.shape)} strides {blk.stride()}")
    rows, d = blk.shape
    if rows < 1 or d < 1:
        raise ValueError(f"empty table slab {tuple(blk.shape)}")
    if rows > 1 and not d <= blk.stride(0) < 2 ** 31:
        raise ValueError(f"table row stride {blk.stride(0)} must be in "
                         f"[{d}, 2**31)")
    if q.device != dev or q.dtype != torch.float32 or q.dim() != 2 \
            or q.shape[1] != d or q.shape[0] < 1 or not q.is_contiguous():
        raise ValueError(f"queries must be contiguous float32 (Q, {d}) on "
                         f"{dev}, got {q.dtype} {tuple(q.shape)} on {q.device}")
    qn = q.shape[0]
    if norms is not None and (norms.device != dev
                              or norms.dtype != torch.float32
                              or tuple(norms.shape) != (rows,)
                              or not norms.is_contiguous()):
        raise ValueError(f"norms must be contiguous float32 ({rows},) on "
                         f"{dev}, got {norms.dtype} {tuple(norms.shape)} "
                         f"on {norms.device}")
    if excl.device != dev or excl.dtype != torch.int32 \
            or tuple(excl.shape) != (qn,) or not excl.is_contiguous():
        raise ValueError(f"exclude_rows must be contiguous int32 ({qn},) on "
                         f"{dev}, got {excl.dtype} {tuple(excl.shape)} on "
                         f"{excl.device}")
    k_run = 0
    if (run_s is None) != (run_i is None):
        raise ValueError("run_s and run_i go together")
    if run_s is not None:
        k_run = run_s.shape[1] if run_s.dim() == 2 else -1
        if run_s.device != dev or run_i.device != dev \
                or run_s.dtype != torch.float32 or run_i.dtype != torch.int32 \
                or tuple(run_s.shape) != (qn, k_run) \
                or tuple(run_i.shape) != (qn, k_run) \
                or not run_s.is_contiguous() or not run_i.is_contiguous():
            raise ValueError("running list must be contiguous float32/int32 "
                             f"(Q, k) on {dev}")
    if not 1 <= k <= k_run + rows:
        raise ValueError(f"k={k} outside [1, {k_run + rows}]")
    if offset < 0 or limit < 0 or offset + rows >= 2 ** 31:
        raise ValueError(f"offset={offset}, limit={limit} out of int32 range")


def topk_cosine_step(q: torch.Tensor, blk: torch.Tensor,
                     norms: Optional[torch.Tensor], excl: torch.Tensor,
                     offset: int, limit: int, k: int,
                     run_s: Optional[torch.Tensor] = None,
                     run_i: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slab step: the best ``k`` of the running list (``run_s``,
    ``run_i``; None for none) and the slab ``blk`` whose row 0 is global
    row ``offset``.  Returns the new ``(scores (Q, k) float32, indices
    (Q, k) int32)``.  Entries past the real candidates hold ``-1e30``."""
    if blk.device.type == "cpu":
        return ref.stream_step_ref(q, blk, norms, int(offset), int(limit),
                                   excl, run_s, run_i, int(k))
    _check(q, blk, norms, excl, offset, limit, k, run_s, run_i)
    with torch.cuda.device(blk.device):
        if k <= SMALL_K_MAX:
            return _step_small(q, blk, norms, excl, offset, limit, k,
                               run_s, run_i)
        return _step_large(q, blk, norms, excl, offset, limit, k,
                           run_s, run_i)


def _step_small(q, blk, norms, excl, offset, limit, k, run_s, run_i):
    qn, d = q.shape
    rows = blk.shape[0]
    dev = blk.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_chunks = -(-rows // CHUNK_ROWS)
    kc = min(k, CHUNK_ROWS)
    cand = torch.empty((qn, n_chunks, kc), dtype=torch.int64, device=dev)
    _launch("topk_select_chunks", q.data_ptr(), qn, d, blk.data_ptr(),
            blk.stride(0), rows, _ptr(norms), excl.data_ptr(), offset,
            limit, kc, cand.data_ptr(), stream)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    k_run = 0 if run_s is None else run_s.shape[1]
    _launch("topk_merge_running", _ptr(run_s), _ptr(run_i), k_run,
            cand.data_ptr(), n_chunks * kc, qn, k, out_s.data_ptr(),
            out_i.data_ptr(), stream)
    return out_s, out_i


def _step_large(q, blk, norms, excl, offset, limit, k, run_s, run_i):
    qn, d = q.shape
    rows = blk.shape[0]
    dev = blk.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    k_run = 0 if run_s is None else run_s.shape[1]
    P = 2
    while P < k_run + rows:
        P *= 2
    keys = torch.empty((qn, P), dtype=torch.int64, device=dev)
    _launch("topk_score_keys", q.data_ptr(), qn, d, blk.data_ptr(),
            blk.stride(0), rows, _ptr(norms), excl.data_ptr(), offset, limit,
            _ptr(run_s), _ptr(run_i), k_run, keys.data_ptr(), P, stream)
    for kind, a, b in bitonic_schedule(P):
        _launch(f"topk_bitonic_{kind}", keys.data_ptr(), qn, P, a, b, stream)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    _launch("topk_gather", keys.data_ptr(), qn, P, k, out_s.data_ptr(),
            out_i.data_ptr(), stream)
    return out_s, out_i
