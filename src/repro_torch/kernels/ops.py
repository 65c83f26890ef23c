"""Public kernel entry points: the top-k streaming driver, the sharded
top-k, KGE scoring and sliding-window attention.

The port of ``repro.kernels.ops`` (``topk_cosine``, ``_topk_stream``,
``topk_cosine_join``, ``stream_stats``, ``mesh_data_shards``,
``shard_table``, ``shard_table_raw``, ``topk_cosine_sharded``,
``kge_score``, ``swa_attention``).
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


# ---------------------------- sharded top-k ---------------------------- #
def mesh_data_shards(mesh, axis: str = "data") -> int:
    """Number of table shards a mesh provides (1 = no sharding)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis, 1))


def _row_blocks(x, mesh, pad: float) -> List[torch.Tensor]:
    """``x`` (N, ...) as one float32 row block a shard, each on its shard's
    device, the last blocks filled with ``pad`` up to ceil(N / S) rows."""
    local = -(-x.shape[0] // len(mesh.devices))
    out = []
    for s, dev in enumerate(mesh.devices):
        part = x[s * local:(s + 1) * local]
        if isinstance(part, torch.Tensor):
            t = part.to(device=dev, dtype=torch.float32, copy=True)
        else:       # a copy also detaches the block from a read-only map
            t = torch.from_numpy(np.array(part, dtype=np.float32)).to(dev)
        if t.shape[0] < local:
            t = torch.cat([t, torch.full((local - t.shape[0],) + t.shape[1:],
                                         pad, dtype=torch.float32,
                                         device=dev)])
        out.append(t.contiguous())
    return out


def shard_table(e_unit, mesh) -> Tuple[List[torch.Tensor], int]:
    """Lay an (N, d) table out in row blocks over ``mesh``'s devices, rows
    zero-padded to a multiple of the shard count.  Returns ``(blocks,
    n_valid)``, ``n_valid`` the real row count: pass both to
    :func:`topk_cosine_sharded`."""
    return _row_blocks(e_unit, mesh, 0.0), int(e_unit.shape[0])


def shard_table_raw(e_table, norms, mesh
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor], int]:
    """:func:`shard_table` for a raw table and its per-row L2 norms: rows
    are zero-padded, norms one-padded (a pad row stays zero after the
    in-kernel division).  Returns ``(blocks, norm blocks, n_valid)``; each
    shard normalizes its own rows in the kernel, so no unit copy of the
    table exists on any device."""
    return (_row_blocks(e_table, mesh, 0.0), _row_blocks(norms, mesh, 1.0),
            int(e_table.shape[0]))


def topk_cosine_sharded(q_unit, e_unit, k: int, exclude_rows=None,
                        mesh=None, n_valid: Optional[int] = None,
                        norms=None, device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-sharded :func:`topk_cosine`: the same ``(scores, indices,
    valid)``, with the table in row blocks over ``mesh``'s ``"data"``
    devices.

    ``e_unit`` (``norms``) is the block list of :func:`shard_table`
    (:func:`shard_table_raw`) or a whole table, split here.  Each shard
    makes one :func:`topk_cosine_step` over its ``local_n`` rows on its own
    device, with the exclusion moved to local rows (-1 where the excluded
    row lives in another shard) and a fetch depth of ``min(k + n_pad,
    local_n)``: the ``n_pad`` zero rows padding N to a multiple of the
    shard count can take at most that many of the last shard's slots, so
    every global top-k row survives its shard.  Pad candidates score
    ``-1e30``.  The merge, on the first shard's device, is a stable
    descending sort of the candidates laid out in shard order, so among
    equal scores the lower global index wins, as in one call.  With one
    shard (or no mesh) this is :func:`topk_cosine` on ``device``."""
    shards = mesh_data_shards(mesh)
    if shards <= 1:
        if isinstance(e_unit, (list, tuple)):
            e_unit = e_unit[0]
            norms = None if norms is None else norms[0]
        n_real = e_unit.shape[0] if n_valid is None else int(n_valid)
        return topk_cosine(q_unit, e_unit[:n_real], k,
                           exclude_rows=exclude_rows,
                           norms=None if norms is None else norms[:n_real],
                           device=device)
    if not isinstance(e_unit, (list, tuple)):
        if e_unit.shape[0] % shards:
            raise ValueError(
                f"table rows ({e_unit.shape[0]}) must divide the 'data' axis "
                f"({shards}); lay the table out with shard_table()")
        e_unit = _row_blocks(e_unit, mesh, 0.0)
        norms = None if norms is None else _row_blocks(norms, mesh, 1.0)
    local_n = e_unit[0].shape[0]
    if len(e_unit) != shards or any(b.shape[0] != local_n for b in e_unit):
        raise ValueError(f"want {shards} blocks of {local_n} rows, got "
                         f"{[tuple(b.shape) for b in e_unit]}")
    n_total = local_n * shards
    n_real = n_total if n_valid is None else int(n_valid)
    k_c = min(int(k), n_real)
    k_fetch = min(int(k) + n_total - n_real, local_n)
    q = torch.as_tensor(q_unit, dtype=torch.float32)
    excl_np = _excl_np(exclude_rows, q.shape[0])
    dev0 = e_unit[0].device
    cand_s, cand_i = [], []
    for s, blk in enumerate(e_unit):
        off = s * local_n
        loc = np.where((excl_np >= off) & (excl_np < off + local_n),
                       excl_np - off, -1).astype(np.int32)
        sc, ix = topk_cosine_step(
            q.to(blk.device).contiguous(), blk,
            None if norms is None else norms[s],
            torch.from_numpy(loc).to(blk.device), 0, local_n, k_fetch)
        gi = ix + off
        cand_s.append(torch.where(gi < n_real, sc, ref.NEG_INF).to(dev0))
        cand_i.append(gi.to(dev0))
    s_all, pos = torch.sort(torch.cat(cand_s, 1), dim=1, descending=True,
                            stable=True)
    idx = torch.gather(torch.cat(cand_i, 1), 1, pos[:, :k_c])
    valid = torch.from_numpy(_valid(excl_np, n_real, k_c)).to(dev0)
    return s_all[:, :k_c].contiguous(), idx.contiguous(), valid


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
