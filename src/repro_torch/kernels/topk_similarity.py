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
a merge.  Larger k takes three stages: score one 64-bit key per slab row,
select and sort the best k of each sub-slab of at most ``SORT_CAP`` rows
in shared memory, and merge each sub-slab's sorted keys into the running
list, which is already sorted, along the merge path: 3 launches for a
streamed slab, 2 + ceil(rows / SORT_CAP) for a device-resident table.

``launches`` counts the kernel launches of each C entry point; a run
resets it and reads it to show that the main path went through the
kernels.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _build, ref

#: largest k served by the two-launch select/merge path
SMALL_K_MAX = 64
#: rows per scoring block (CHUNK in topk_cosine.cu)
CHUNK_ROWS = 256
#: rows of one sub-slab of the large-k path, all its keys in shared
#: memory (SORT_CAP in topk_cosine.cu); >= ops.STREAM_BLOCK_ROWS
SORT_CAP = 8192
#: outputs per merge-path block (MERGE_TILE in topk_cosine.cu)
MERGE_TILE = 256

# Every entry point takes its arguments packed (``_build.Library``), in
# this order; a null pointer is 0:
#   topk_select_chunks: q, Q, d, tbl, stride, rows, norms, excl, offset,
#                       limit, kc, cand, stream
#   topk_merge_running: run_s, run_i, k_run, cand, n_cand, Q, k, out_s,
#                       out_i, stream
#   topk_score_keys:    q, Q, d, tbl, stride, rows, norms, excl, offset,
#                       limit, keys, stream
#   topk_select_sort:   keys, Q, rows, k, cand, stream
#   topk_merge_path:    run_s, run_i, k_run, cand, cand_stride, n_cand, Q,
#                       k_out, out_s, out_i, stream
_LIB = _build.Library("topk_cosine", {
    "topk_select_chunks": 13, "topk_merge_running": 10,
    "topk_score_keys": 12, "topk_select_sort": 6, "topk_merge_path": 11})
_launch = _LIB.launch
#: kernel launches per C entry point since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def merge_path_split(a: Sequence[int], b: Sequence[int], diag: int) -> int:
    """How many of the first ``diag`` entries of the descending merge of
    the descending key lists ``a`` (the running list) and ``b`` (a
    sub-slab's candidates) come from ``a``; equal keys take ``a`` first.
    The search each merge-path block's warp runs (``merge_split`` in
    topk_cosine.cu): per round, 32 lanes test 32 evenly spaced entries of
    ``a``.  Kept in Python so the CPU tests can replay it."""
    lo, hi = max(0, diag - len(b)), min(diag, len(a))
    while lo < hi:
        step = (hi - lo + 31) // 32
        n_take = sum(1 for lane in range(32)
                     if lo + lane * step < hi
                     and a[lo + lane * step] >= b[diag - 1 - lo - lane * step])
        next_hi = min(hi, lo + n_take * step)
        if n_take:
            lo += (n_take - 1) * step + 1
        hi = next_hi
    return lo


def large_k_merges(rows: int, k: int, k_run: int) -> List[Tuple[int, int]]:
    """The merge-path launches of one large-k step over ``rows`` slab rows:
    ``(n_cand, k_out)`` per sub-slab, in order; the last ``k_out`` is
    ``k``."""
    merges = []
    for start in range(0, rows, SORT_CAP):
        n_cand = min(k, rows - start, SORT_CAP)
        k_run = min(k, k_run + n_cand)
        merges.append((n_cand, k_run))
    return merges


_F32, _I32 = torch.float32, torch.int32


def _check(q, blk, norms, excl, offset, limit, k, run_s, run_i) -> None:
    """Raises ``ValueError`` on anything the kernels do not take; each
    tensor's metadata is read once."""
    dev, bs = blk.device, blk.shape
    if blk.dtype is not _F32 or len(bs) != 2 or blk.stride(1) != 1:
        raise ValueError("table slab must be float32 (rows, d) with "
                         f"unit column stride, got {blk.dtype} "
                         f"{tuple(bs)} strides {blk.stride()}")
    rows, d = bs
    if rows < 1 or d < 1:
        raise ValueError(f"empty table slab {tuple(bs)}")
    if rows > 1 and not d <= blk.stride(0) < 2 ** 31:
        raise ValueError(f"table row stride {blk.stride(0)} must be in "
                         f"[{d}, 2**31)")
    qs = q.shape
    if q.dtype is not _F32 or len(qs) != 2 or qs[1] != d or qs[0] < 1 \
            or not q.is_contiguous() or q.device != dev:
        raise ValueError(f"queries must be contiguous float32 (Q, {d}) on "
                         f"{dev}, got {q.dtype} {tuple(qs)} on {q.device}")
    qn = qs[0]
    if norms is not None and (norms.dtype is not _F32
                              or norms.shape != (rows,)
                              or not norms.is_contiguous()
                              or norms.device != dev):
        raise ValueError(f"norms must be contiguous float32 ({rows},) on "
                         f"{dev}, got {norms.dtype} {tuple(norms.shape)} "
                         f"on {norms.device}")
    if excl.dtype is not _I32 or excl.shape != (qn,) \
            or not excl.is_contiguous() or excl.device != dev:
        raise ValueError(f"exclude_rows must be contiguous int32 ({qn},) on "
                         f"{dev}, got {excl.dtype} {tuple(excl.shape)} on "
                         f"{excl.device}")
    k_run = 0
    if (run_s is None) != (run_i is None):
        raise ValueError("run_s and run_i go together")
    if run_s is not None:
        rs = run_s.shape
        k_run = rs[1] if len(rs) == 2 else -1
        if run_s.dtype is not _F32 or run_i.dtype is not _I32 \
                or rs != (qn, k_run) or run_i.shape != rs \
                or not run_s.is_contiguous() or not run_i.is_contiguous() \
                or run_s.device != dev or run_i.device != dev:
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
    with _build.on_device(blk.device):
        if k <= SMALL_K_MAX:
            return _step_small(q, blk, norms, excl, offset, limit, k,
                               run_s, run_i)
        return _step_large(q, blk, norms, excl, offset, limit, k,
                           run_s, run_i)


def _step_small(q, blk, norms, excl, offset, limit, k, run_s, run_i):
    qn, d = q.shape
    rows = blk.shape[0]
    dev = blk.device
    stream = _build.stream_handle(dev)
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
    stream = _build.stream_handle(dev)
    n_sub, m_cap = -(-rows // SORT_CAP), min(k, SORT_CAP)
    # one scratch allocation: the keys (Q, rows), then the sorted
    # candidates (Q, n_sub, m_cap)
    scratch = torch.empty(qn * (rows + n_sub * m_cap), dtype=torch.int64,
                          device=dev)
    keys = scratch.data_ptr()
    cand = keys + qn * rows * 8
    _launch("topk_score_keys", q.data_ptr(), qn, d, blk.data_ptr(),
            blk.stride(0), rows, _ptr(norms), excl.data_ptr(), offset, limit,
            keys, stream)
    _launch("topk_select_sort", keys, qn, rows, k, cand, stream)
    k_run = 0 if run_s is None else run_s.shape[1]
    for j, (n_cand, k_out) in enumerate(large_k_merges(rows, k, k_run)):
        out_s = torch.empty(qn, k_out, dtype=_F32, device=dev)
        out_i = torch.empty(qn, k_out, dtype=_I32, device=dev)
        _launch("topk_merge_path", _ptr(run_s), _ptr(run_i), k_run,
                cand + j * m_cap * 8, n_sub * m_cap, n_cand, qn, k_out,
                out_s.data_ptr(), out_i.data_ptr(), stream)
        run_s, run_i, k_run = out_s, out_i, k_out
    return run_s, run_i
