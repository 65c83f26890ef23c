"""Public kernel entry points: the top-k streaming driver, KGE scoring and
sliding-window attention.

The port of ``repro.kernels.ops`` (``topk_cosine``, ``_topk_stream``,
``topk_cosine_join``, ``stream_stats``, ``kge_score``, ``swa_attention``).
There is no backend flag: on the card the CUDA kernels run, on the CPU
their plain PyTorch versions (the wrappers in
:mod:`repro_torch.kernels.topk_similarity`,
:mod:`repro_torch.kernels.kge_score` and
:mod:`repro_torch.kernels.swa_attention` decide by the tensor's device).

Streaming table residency: when ``topk_cosine`` receives a host table
(``np.ndarray`` / ``np.memmap``), the whole ``(N, d)`` array never goes to
the device.  The driver walks it in fixed ``block_rows`` slabs: each slab
is gathered into contiguous staging, copied host to device, scored with
the sidecar ``norms`` folded into the kernel, and merged into a running
``(Q, k')`` top-k.  Peak device memory for the table is one or two slabs
regardless of N; ``stream_stats`` records the largest slab transfer.  A
``torch.Tensor`` table takes the single-call path over the whole table on
that tensor's device.

On the card, slabs are staged in pinned host memory and copied with
``non_blocking=True``.  A staging buffer is written again only after the
event recorded behind its last copy has completed: reusing it earlier
would overwrite rows an in-flight copy is still reading, the bug the JAX
driver once had with a reused numpy scratch buffer.  Staging sets come
from a :class:`StagingPool`, one set per call at a time, so concurrent
flush threads never share one.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import kge_score as _kge, ref, swa_attention as _swa
from .topk_similarity import topk_cosine_step

#: host-slab size for the streaming driver: 8192 rows x 200 dims x 4 B is
#: 6.6 MB per transfer, enough to amortize a copy and two launches
STREAM_BLOCK_ROWS = 8192

#: cumulative streaming-driver counters (reset with reset_stream_stats):
#: ``peak_block_bytes`` is the largest single slab transfer (rows + norms)
#: any streamed call made — O(block_rows * d), never the full table
stream_stats = {"calls": 0, "blocks": 0, "peak_block_bytes": 0}
_stats_lock = threading.Lock()


def reset_stream_stats() -> None:
    with _stats_lock:
        stream_stats.update({"calls": 0, "blocks": 0, "peak_block_bytes": 0})


class _Slabs:
    """Two pinned host slabs and two device slabs (rows + norms) for one
    ``(block_rows, d)`` shape, with the events that guard their reuse."""

    def __init__(self, bs: int, d: int, device: torch.device):
        self.key = (bs, d, device)
        self.host = [torch.empty((bs, d), dtype=torch.float32,
                                 pin_memory=True) for _ in range(2)]
        self.host_n = [torch.empty((bs,), dtype=torch.float32,
                                   pin_memory=True) for _ in range(2)]
        self.dev = [torch.empty((bs, d), dtype=torch.float32, device=device)
                    for _ in range(2)]
        self.dev_n = [torch.empty((bs,), dtype=torch.float32, device=device)
                      for _ in range(2)]
        #: event behind the last host-to-device copy out of host[b]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        #: event behind the last kernel of the call that used this set
        self.done: Optional[torch.cuda.Event] = None


class StagingPool:
    """Reusable pinned staging for the streaming driver.

    Pinned allocations cost milliseconds, more than a slab copy, so an
    index keeps its staging across calls.  ``acquire`` hands a set to one
    call at a time; ``release`` returns it with an event behind the call's
    last kernel, which the next user's stream waits on before it touches
    the device slabs."""

    #: free sets kept per slab shape; more concurrent calls than this
    #: allocate and drop their own
    MAX_FREE = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[tuple, List[_Slabs]] = {}

    def acquire(self, bs: int, d: int, device: torch.device) -> _Slabs:
        key = (bs, d, device)
        with self._lock:
            free = self._free.get(key)
            slabs = free.pop() if free else None
        if slabs is None:
            return _Slabs(bs, d, device)
        if slabs.done is not None:
            torch.cuda.current_stream(device).wait_event(slabs.done)
        return slabs

    def release(self, slabs: _Slabs) -> None:
        slabs.done = torch.cuda.Event()
        slabs.done.record(torch.cuda.current_stream(slabs.key[2]))
        with self._lock:
            free = self._free.setdefault(slabs.key, [])
            if len(free) < self.MAX_FREE:
                free.append(slabs)


def _excl_np(exclude_rows, qn: int) -> np.ndarray:
    if exclude_rows is None:
        return np.full((qn,), -1, np.int32)
    return np.asarray(exclude_rows, np.int32)


def _valid(excl_np: np.ndarray, n: int, k_c: int) -> np.ndarray:
    excluded = ((excl_np >= 0) & (excl_np < n)).astype(np.int32)
    return np.minimum(k_c, n - excluded).astype(np.int32)


def _topk_stream(q_unit, e_table: np.ndarray, k: int, exclude_rows, norms,
                 block_rows: int, device: torch.device,
                 staging: Optional[StagingPool]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host-slab streaming over an ``np.ndarray``/``np.memmap`` table: per
    slab, gather ``(rows, d)`` into contiguous staging, copy it to the
    device, score it (norms folded in-kernel), merge into the running
    ``(Q, k')`` top-k.  The table is never resident on the device and
    never normalized as a whole anywhere."""
    n, d = e_table.shape
    k_c = min(int(k), n)
    bs = min(int(block_rows), n)
    q = torch.as_tensor(np.asarray(q_unit, np.float32)).to(device)
    qn = q.shape[0]
    excl_np = _excl_np(exclude_rows, qn)
    excl = torch.from_numpy(excl_np).to(device)
    norms_np = None if norms is None else np.asarray(norms)
    run_s = torch.full((qn, k_c), ref.NEG_INF, dtype=torch.float32,
                       device=device)
    run_i = torch.zeros((qn, k_c), dtype=torch.int32, device=device)
    on_card = device.type == "cuda"
    pool = staging if staging is not None else StagingPool()
    slabs = pool.acquire(bs, d, device) if on_card else None
    peak = n_blocks = 0
    try:
        for b, start in enumerate(range(0, n, bs)):
            rows = min(bs, n - start)
            if on_card:
                blk, nrm = _stage_on_card(slabs, b % 2, e_table, norms_np,
                                          start, rows)
            else:
                # fresh arrays per slab: the CPU path is synchronous, and a
                # copy also detaches the tensor from a read-only memmap
                blk = torch.from_numpy(np.array(e_table[start:start + rows],
                                                dtype=np.float32))
                nrm = (None if norms_np is None else torch.from_numpy(
                    np.array(norms_np[start:start + rows], dtype=np.float32)))
            run_s, run_i = topk_cosine_step(q, blk, nrm, excl, start, n, k_c,
                                            run_s, run_i)
            peak = max(peak, rows * d * 4 + (0 if nrm is None else rows * 4))
            n_blocks += 1
    finally:
        if on_card:
            pool.release(slabs)
    with _stats_lock:
        stream_stats["calls"] += 1
        stream_stats["blocks"] += n_blocks
        stream_stats["peak_block_bytes"] = max(
            stream_stats["peak_block_bytes"], peak)
    valid = torch.from_numpy(_valid(excl_np, n, k_c)).to(device)
    return run_s, run_i, valid


def _stage_on_card(slabs: _Slabs, b: int, e_table: np.ndarray,
                   norms_np: Optional[np.ndarray], start: int, rows: int):
    """Gather slab rows into pinned ``host[b]`` (waiting first for the copy
    that last read it), then copy them to ``dev[b]`` asynchronously and
    record the event that guards ``host[b]``'s next reuse.  The kernel that
    reads ``dev[b]`` is queued behind the copy on the same stream."""
    stream = torch.cuda.current_stream(slabs.key[2])
    if slabs.copied[b] is not None:
        slabs.copied[b].synchronize()
    host = slabs.host[b][:rows]
    np.copyto(host.numpy(), e_table[start:start + rows], casting="same_kind")
    blk = slabs.dev[b][:rows]
    blk.copy_(host, non_blocking=True)
    nrm = None
    if norms_np is not None:
        host_n = slabs.host_n[b][:rows]
        np.copyto(host_n.numpy(), norms_np[start:start + rows],
                  casting="same_kind")
        nrm = slabs.dev_n[b][:rows]
        nrm.copy_(host_n, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(stream)
    slabs.copied[b] = ev
    return blk, nrm


def topk_cosine(q_unit, e_table, k: int, exclude_rows=None, norms=None,
                block_rows: Optional[int] = None, device=None,
                staging: Optional[StagingPool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q, d) x (N, d) -> (scores, indices, valid), descending per row.

    k is clamped to N; ``exclude_rows`` (-1 = none) masks one table row per
    query inside the kernel; entries past ``valid[q]`` are sentinel
    padding that callers must not surface.

    ``e_table`` may be a host ``np.ndarray``/``np.memmap``: the streaming
    driver runs on ``device`` (``resolve_device``: default the card).  A
    ``torch.Tensor`` table is scored in one call on its own device.
    ``norms`` (per-row L2) lets both paths score a raw table.  Results are
    tensors on the device that did the work."""
    if not isinstance(e_table, torch.Tensor):
        return _topk_stream(q_unit, np.asarray(e_table), k, exclude_rows,
                            norms, block_rows or STREAM_BLOCK_ROWS,
                            resolve_device(device), staging)
    dev = e_table.device
    n = e_table.shape[0]
    k_c = min(int(k), n)
    q = torch.as_tensor(q_unit, dtype=torch.float32, device=dev).contiguous()
    excl_np = _excl_np(exclude_rows, q.shape[0])
    excl = torch.from_numpy(excl_np).to(dev)
    if norms is not None and not isinstance(norms, torch.Tensor):
        norms = np.array(norms, dtype=np.float32)    # off a read-only map
    nrm = (None if norms is None else torch.as_tensor(
        norms, dtype=torch.float32, device=dev).contiguous())
    s, i = topk_cosine_step(q, e_table.to(torch.float32), nrm, excl, 0, n,
                            k_c)
    return s, i, torch.from_numpy(_valid(excl_np, n, k_c)).to(dev)


def topk_cosine_join(q_unit, e_table, k: int, exclude_rows=None, norms=None,
                     query_block_rows: int = 256,
                     block_rows: Optional[int] = None, device=None,
                     staging: Optional[StagingPool] = None):
    """Slab-iterated all-pairs kNN join: generator over query slabs.

    Walks the (Q, d) query block in fixed ``query_block_rows`` slabs and
    runs each through :func:`topk_cosine`, yielding ``(start, scores,
    indices, valid)`` as numpy arrays trimmed to the slab's real rows.  The
    final partial slab is zero-padded up to ``query_block_rows`` (pad
    exclusions -1) so every slab has one shape; pad rows are dropped
    before yielding."""
    q = np.asarray(q_unit, np.float32)
    qn = q.shape[0]
    s = max(1, int(query_block_rows))
    excl_np = _excl_np(exclude_rows, qn)
    for start in range(0, qn, s):
        rows = min(s, qn - start)
        q_slab = q[start:start + rows]
        e_slab = excl_np[start:start + rows]
        if rows < s:
            q_slab = np.concatenate(
                [q_slab, np.zeros((s - rows, q.shape[1]), np.float32)])
            e_slab = np.concatenate(
                [e_slab, np.full((s - rows,), -1, np.int32)])
        sc, ix, va = topk_cosine(q_slab, e_table, k, exclude_rows=e_slab,
                                 norms=norms, block_rows=block_rows,
                                 device=device, staging=staging)
        yield (start, sc.cpu().numpy()[:rows], ix.cpu().numpy()[:rows],
               va.cpu().numpy()[:rows])


# ------------------------------ kge_score ------------------------------ #
class _KGEScore(torch.autograd.Function):
    """Forward and backward both in ``csrc/kge_score.cu`` on the card, in
    their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, h, r, t, neg, corrupt_head, model):
        ctx.model = model
        ctx.save_for_backward(h, r, t, neg, corrupt_head)
        return _kge.kge_score_forward(h, r, t, neg, corrupt_head, model)

    @staticmethod
    def backward(ctx, g_pos, g_negs):
        # an output the loss does not use arrives as zeros (autograd
        # materialises it)
        h, r, t, neg, corrupt_head = ctx.saved_tensors
        gh, gr, gt, gneg = _kge.kge_score_backward(
            h, r, t, neg, corrupt_head, g_pos.contiguous(),
            g_negs.contiguous(), ctx.model)
        return gh, gr, gt, gneg, None, None


def kge_score(h: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
              neg: torch.Tensor, corrupt_head: torch.Tensor,
              model: str = "transe_l1") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused positive + negative KGE scoring, differentiable in ``h``,
    ``r``, ``t`` and ``neg``: ``(pos (B,), negs (B, K))``.  ``model`` is
    ``"transe_l1"``, ``"transe_l2"`` or ``"distmult"``; ``corrupt_head``
    (B, K) is true where the negative replaces the head."""
    return _KGEScore.apply(h, r, t, neg, corrupt_head, model)


# ---------------------------- swa_attention ---------------------------- #
def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, q_offset: int = 0) -> torch.Tensor:
    """Sliding-window GQA attention on ``(B, H, S, d)`` tensors (the
    reference layout): heads are folded into the leading dim for the
    kernel (kv row = q row // (Hq / Hkv)).  Returns ``(B, Hq, Sq, d)``."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out = _swa.swa_attention_forward(
        q.contiguous().reshape(b * hq, sq, d),
        k.contiguous().reshape(b * hkv, skv, d),
        v.contiguous().reshape(b * hkv, skv, d), window, q_offset)
    return out.reshape(b, hq, sq, d)
