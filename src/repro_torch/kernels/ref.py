"""Plain PyTorch versions of the top-k kernel: the semantics the CUDA
kernel is held to.

These run on the CPU (the tests) and on the card (``chip_smoke.py``
compares the kernel with them on the same inputs).  They are
straightforward tensor code, not a yardstick of speed.

Ties: ``torch.topk`` orders equal scores arbitrarily on both CPU and CUDA,
so every selection here is ``torch.sort(..., descending=True,
stable=True)`` over candidates laid out in ascending global index (running
entries first; they always carry lower indices than the current slab's).
Among equal scores the lower global index therefore wins, as in the
reference's one-shot ``lax.top_k``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def no_tf32() -> None:
    """fp32 matmuls in full fp32: with TF32 on, the 1e-5 score tolerance
    against the kernel fails.  Called wherever a plain version may run on
    the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _excl_or_none(exclude_rows, qn: int, device) -> torch.Tensor:
    if exclude_rows is None:
        return torch.full((qn,), -1, dtype=torch.int32, device=device)
    return torch.as_tensor(exclude_rows, dtype=torch.int32, device=device)


def valid_counts(excl: torch.Tensor, n: int, k_c: int) -> torch.Tensor:
    """``min(k', N - excluded)`` per query: how many leading entries of a
    result row are real (the rest are sentinel padding)."""
    excluded = ((excl >= 0) & (excl < n)).to(torch.int32)
    return torch.clamp(n - excluded, max=k_c).to(torch.int32)


def stream_step_ref(q: torch.Tensor, blk: torch.Tensor,
                    nrm: Optional[torch.Tensor], offset: int, limit: int,
                    excl: torch.Tensor, run_s: Optional[torch.Tensor],
                    run_i: Optional[torch.Tensor], k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score one ``(rows, d)`` slab whose first row is global row
    ``offset`` and merge it into the running ``(Q, k)`` top-k.

    With ``nrm`` each row is scored as ``e / max(norm, 1e-12)``.  Columns
    ``>= limit`` and each query's ``excl`` column score ``NEG_INF``.
    ``run_s``/``run_i`` may be None (no running list: a one-shot call over
    a whole table).  Returns the new running ``(scores, indices)``."""
    if q.is_cuda:
        no_tf32()
    if nrm is not None:
        blk = blk / torch.clamp(nrm[:, None], min=1e-12)
    s = q @ blk.T                                              # (Q, rows)
    col = offset + torch.arange(blk.shape[0], dtype=torch.int32,
                                device=q.device)[None, :]
    neg = torch.tensor(NEG_INF, dtype=s.dtype, device=s.device)
    s = torch.where(col < limit, s, neg)                       # past the table
    s = torch.where(col == excl[:, None], neg, s)              # self-exclusion
    cand_i = col.expand(q.shape[0], -1)
    if run_s is not None:
        s = torch.cat([run_s, s], dim=1)
        cand_i = torch.cat([run_i, cand_i], dim=1)
    s2, pos = torch.sort(s, dim=1, descending=True, stable=True)
    pos = pos[:, :k]
    return s2[:, :k].contiguous(), torch.gather(cand_i, 1, pos).contiguous()


def topk_cosine_blocked_ref(q_unit: torch.Tensor, e_table: torch.Tensor,
                            k: int, exclude_rows=None,
                            norms: Optional[torch.Tensor] = None,
                            block_n: int = 1024
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Blocked top-k: the same contract as :func:`topk_cosine_ref`,
    computed over ``(block_n, d)`` row tiles with a running merge.  With
    ``norms`` the table may be raw rows, normalized per tile."""
    n = e_table.shape[0]
    qn = q_unit.shape[0]
    k_c = min(int(k), n)
    dev = e_table.device
    q = q_unit.to(device=dev, dtype=torch.float32)
    excl = _excl_or_none(exclude_rows, qn, dev)
    run_s = torch.full((qn, k_c), NEG_INF, dtype=torch.float32, device=dev)
    run_i = torch.zeros((qn, k_c), dtype=torch.int32, device=dev)
    for start in range(0, n, block_n):
        blk = e_table[start:start + block_n].to(torch.float32)
        nrm = None if norms is None else norms[start:start + block_n]
        run_s, run_i = stream_step_ref(q, blk, nrm, start, n, excl,
                                       run_s, run_i, k_c)
    return run_s, run_i, valid_counts(excl, n, k_c)


def topk_cosine_ref(q_unit: torch.Tensor, e_unit: torch.Tensor, k: int,
                    exclude_rows=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``q_unit (Q, d)``, ``e_unit (N, d)``, both row-normalized.

    Returns ``(scores (Q, k'), indices (Q, k'), valid (Q,))`` sorted
    descending, ``k' = min(k, N)``.  ``exclude_rows`` masks one table row
    per query (-1 = none); entries past ``valid[q]`` are sentinel
    padding."""
    n = e_unit.shape[0]
    k_c = min(int(k), n)
    dev = e_unit.device
    excl = _excl_or_none(exclude_rows, q_unit.shape[0], dev)
    s, i = stream_step_ref(q_unit.to(device=dev, dtype=torch.float32),
                           e_unit.to(torch.float32), None, 0, n, excl,
                           None, None, k_c)
    return s, i, valid_counts(excl, n, k_c)
