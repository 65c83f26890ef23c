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
Both paths score with one scorer, in blocks of ``SCORE_ROWS`` slab rows.
k <= 64 (the paper's k = 10) takes two launches: score and keep each
block's best ``min(k, 64)`` per query, sorted, then merge those runs and
the running list (:func:`small_k_merge_model` replays both on the host).
Larger k takes three stages: score one 64-bit key per slab row, select
and sort the best k of each sub-slab of at most ``SORT_CAP`` rows in
shared memory, and merge each sub-slab's sorted keys into the running
list along the merge path: 3 launches for a streamed slab,
2 + ceil(rows / SORT_CAP) for a device-resident table, and one more of
the last two for every 65,535 queries past the first (the grid's y
limit; :func:`query_chunks`).  The running list
is sorted, as every step returns it.

``launches`` counts the kernel launches of each C entry point; a run
resets it and reads it to show that the main path went through the
kernels.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, ref

#: largest k served by the two-launch select/merge path
SMALL_K_MAX = 64
#: slab rows per scoring block (SR in topk_cosine.cu): the k <= 64 path
#: keeps the best min(k, 64) of each block
SCORE_ROWS = 64
#: rows of one sub-slab of the large-k path, all its keys in shared
#: memory (SORT_CAP in topk_cosine.cu); >= ops.STREAM_BLOCK_ROWS
SORT_CAP = 8192
#: outputs per merge-path block (MERGE_TILE in topk_cosine.cu)
MERGE_TILE = 256
#: queries of one select/sort or merge-path launch: both put the query on
#: the grid's y axis, whose limit this is
MAX_GRID_Y = 65535

# Every entry point takes its arguments packed (``_build.Library``), in
# this order; a null pointer is 0:
#   topk_score_select:  q, Q, d, tbl, stride, rows, norms, excl, offset,
#                       limit, kc, cand, stream
#   topk_merge_lists:   run_s, run_i, k_run, cand, n_lists, kc, Q, k,
#                       out_s, out_i, stream
#   topk_score_keys:    q, Q, d, tbl, stride, rows, norms, excl, offset,
#                       limit, keys, stream
#   topk_select_sort:   keys, Q, rows, k, cand, stream
#   topk_merge_path:    run_s, run_i, k_run, cand, cand_stride, n_cand, Q,
#                       k_out, out_s, out_i, stream
_LIB = _build.Library("topk_cosine", {
    "topk_score_select": 13, "topk_merge_lists": 11,
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


def score_keys(scores: np.ndarray, index: np.ndarray) -> np.ndarray:
    """``make_key`` of topk_cosine.cu: one uint64 per (fp32 score, global
    index) pair (the two broadcast), larger exactly when better (score,
    then lower index)."""
    s = np.where(scores == 0, 0, scores).astype(np.float32)    # -0 is +0
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u >> np.uint64(31), ~u & np.uint64(0xFFFFFFFF),
                 u | np.uint64(0x80000000))
    idx = np.asarray(index).astype(np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx)


def decode_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(scores float32, indices int32)`` of uint64 keys; key 0 is the
    sentinel ``(-1e30, 0)``."""
    u = (keys >> np.uint64(32)).astype(np.uint32)
    u = np.where(u >> 31, u & np.uint32(0x7FFFFFFF), ~u).astype(np.uint32)
    idx = (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF)))
    none = keys == 0
    return (np.where(none, np.float32(ref.NEG_INF), u.view(np.float32)),
            np.where(none, 0, idx.astype(np.int64)).astype(np.int32))


def merge_lists_warps(n_lists: int) -> int:
    """Warps of one ``merge_lists_kernel`` block: about 8 runs a warp, a
    power of two, at most 32 (``topk_merge_lists_launch``)."""
    warps = 1
    while warps < 32 and warps * 8 < n_lists:
        warps <<= 1
    return warps


def small_k_merge_model(keys: np.ndarray, run_keys: Optional[np.ndarray],
                        k: int) -> np.ndarray:
    """The k <= 64 step on the host, key for key: ``keys (Q, rows)`` of
    one slab's masked scores (:func:`score_keys`), the sorted running
    list's keys ``(Q, k_run)`` or None.  Each block of
    ``SCORE_ROWS`` rows keeps its best ``kc = min(k, 64)`` (rows past the
    slab are key 0); each warp of the merge walks every ``n_warps``-th
    run, skips a run whose head is not above its k-th key and otherwise
    keeps the best 64 of the union; the warps' lists meet pairwise.
    Returns the ``(Q, k)`` result keys.  Kept in Python so the CPU tests
    can replay the kernels' selection against the plain version."""
    qn, rows = keys.shape
    kc = min(k, SCORE_ROWS)
    n_lists = -(-rows // SCORE_ROWS)
    pad = np.zeros((qn, n_lists * SCORE_ROWS), np.uint64)
    pad[:, :rows] = keys
    blocks = np.sort(pad.reshape(qn, n_lists, SCORE_ROWS), axis=2)
    cand = blocks[:, :, ::-1][:, :, :kc]                # sorted, descending
    n_warps = merge_lists_warps(n_lists)

    def best64(a, b):
        return np.sort(np.concatenate([a, b]))[::-1][:64]

    out = np.zeros((qn, k), np.uint64)
    for qi in range(qn):
        lists = []
        for w in range(n_warps):
            best = np.zeros(64, np.uint64)
            if w == 0 and run_keys is not None:
                head = run_keys[qi, :64]
                best[:len(head)] = head
            for b in range(w, n_lists, n_warps):
                if cand[qi, b, 0] > best[k - 1]:
                    best = best64(best, cand[qi, b])
            lists.append(best)
        s = n_warps // 2
        while s:
            for w in range(s):
                lists[w] = best64(lists[w], lists[w + s])
            s //= 2
        out[qi] = lists[0][:k]
    return out


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
    ``run_i``, sorted as a step returns it; None for none) and the slab
    ``blk`` whose row 0 is global row ``offset``.  Returns the new ``(scores (Q, k) float32, indices
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
    n_lists = -(-rows // SCORE_ROWS)
    kc = min(k, SCORE_ROWS)
    cand = torch.empty((qn, n_lists, kc), dtype=torch.int64, device=dev)
    _launch("topk_score_select", q.data_ptr(), qn, d, blk.data_ptr(),
            blk.stride(0), rows, _ptr(norms), excl.data_ptr(), offset,
            limit, kc, cand.data_ptr(), stream)
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    k_run = 0 if run_s is None else run_s.shape[1]
    _launch("topk_merge_lists", _ptr(run_s), _ptr(run_i), k_run,
            cand.data_ptr(), n_lists, kc, qn, k, out_s.data_ptr(),
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
    chunks = query_chunks(qn)
    for q0, nq in chunks:
        _launch("topk_select_sort", keys + q0 * rows * 8, nq, rows, k,
                cand + q0 * n_sub * m_cap * 8, stream)
    k_run = 0 if run_s is None else run_s.shape[1]
    for j, (n_cand, k_out) in enumerate(large_k_merges(rows, k, k_run)):
        out_s = torch.empty(qn, k_out, dtype=_F32, device=dev)
        out_i = torch.empty(qn, k_out, dtype=_I32, device=dev)
        rs, ri = _ptr(run_s), _ptr(run_i)
        for q0, nq in chunks:
            # a row of the running list and of the output is 4 bytes an
            # entry; a null running list stays null
            _launch("topk_merge_path", rs and rs + q0 * k_run * 4,
                    ri and ri + q0 * k_run * 4, k_run,
                    cand + (q0 * n_sub + j) * m_cap * 8, n_sub * m_cap,
                    n_cand, nq, k_out, out_s.data_ptr() + q0 * k_out * 4,
                    out_i.data_ptr() + q0 * k_out * 4, stream)
        run_s, run_i, k_run = out_s, out_i, k_out
    return run_s, run_i


def query_chunks(qn: int) -> List[Tuple[int, int]]:
    """``(first query, queries)`` of each select/sort and merge-path launch
    of a large-k step over ``qn`` queries: one launch up to
    :data:`MAX_GRID_Y` queries, more past it."""
    return [(q0, min(MAX_GRID_Y, qn - q0)) for q0 in range(0, qn, MAX_GRID_Y)]
