"""Plain PyTorch versions of the port's kernels (top-k, KGE scoring,
sliding-window attention, Mamba's selective scan): the semantics each CUDA
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
import torch.nn.functional as F

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


# ------------------------------ kge_score ------------------------------ #
#: the models ``kge_score`` computes, in the order of the CUDA kernel's
#: model argument
KGE_MODELS = ("transe_l1", "transe_l2", "distmult")


def kge_score_ref(
    h: torch.Tensor,            # (B, d) head embeddings
    r: torch.Tensor,            # (B, d) relation embeddings
    t: torch.Tensor,            # (B, d) tail embeddings
    neg: torch.Tensor,          # (B, K, d) corrupting entity embeddings
    corrupt_head: torch.Tensor, # (B, K) bool — True: neg replaces head
    model: str = "transe_l1",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused positive + negative scoring. Returns (pos (B,), neg (B, K)).
    A copy of ``repro.kernels.ref.kge_score_ref``."""
    ch = corrupt_head.bool()
    if model == "transe_l1":
        pos = -torch.sum(torch.abs(h + r - t), dim=-1)
        diff_h = neg + r[:, None, :] - t[:, None, :]    # neg as head
        diff_t = h[:, None, :] + r[:, None, :] - neg    # neg as tail
        diff = torch.where(ch[..., None], diff_h, diff_t)
        negs = -torch.sum(torch.abs(diff), dim=-1)
    elif model == "transe_l2":
        pos = -torch.sqrt(torch.sum((h + r - t) ** 2, dim=-1) + 1e-12)
        diff_h = neg + r[:, None, :] - t[:, None, :]
        diff_t = h[:, None, :] + r[:, None, :] - neg
        diff = torch.where(ch[..., None], diff_h, diff_t)
        negs = -torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    elif model == "distmult":
        pos = torch.sum(h * r * t, dim=-1)
        s_h = torch.sum(neg * (r * t)[:, None, :], dim=-1)
        s_t = torch.sum((h * r)[:, None, :] * neg, dim=-1)
        negs = torch.where(ch, s_h, s_t)
    else:
        raise ValueError(model)
    return pos, negs


def kge_score_backward_ref(
    h: torch.Tensor, r: torch.Tensor, t: torch.Tensor, neg: torch.Tensor,
    corrupt_head: torch.Tensor, g_pos: torch.Tensor, g_negs: torch.Tensor,
    model: str = "transe_l1",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`kge_score_ref`, written out: given the
    cotangents ``g_pos (B,)`` and ``g_negs (B, K)``, returns ``(grad_h,
    grad_r, grad_t (B, d), grad_neg (B, K, d))``.

    With ``x`` the TransE difference (``h + r - t``, with ``neg`` in the
    corrupted slot), the score is ``-sum|x|`` or ``-sqrt(sum x^2 + 1e-12)``
    and its derivative in ``x`` is ``-sign(x)`` or ``-x / sqrt(...)``.
    ``sign`` follows JAX's derivative of ``|x|``: +1 at ``x >= 0``, 0
    included (``torch.abs`` would give 0 there).  DistMult's score ``sum
    h*r*t`` is linear in each factor.  The CUDA backward in
    ``csrc/kge_score.cu`` forms every product and difference in the same
    order as this function."""
    ch = corrupt_head.bool()[..., None]                          # (B, K, 1)
    gp = g_pos[:, None]                                          # (B, 1)
    gn = g_negs[..., None]                                       # (B, K, 1)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    if model in ("transe_l1", "transe_l2"):
        hr = h + r
        x_pos = hr - t                                           # (B, d)
        x_neg = torch.where(ch, (neg + r[:, None, :]) - t[:, None, :],
                            hr[:, None, :] - neg)                # (B, K, d)
        if model == "transe_l1":
            one = torch.ones((), dtype=h.dtype, device=h.device)
            gx_pos = -gp * torch.where(x_pos >= 0, one, -one)
            gx_neg = -gn * torch.where(x_neg >= 0, one, -one)
        else:
            c_pos = -g_pos / torch.sqrt(torch.sum(x_pos * x_pos, -1) + 1e-12)
            c_neg = -g_negs / torch.sqrt(torch.sum(x_neg * x_neg, -1) + 1e-12)
            gx_pos = c_pos[:, None] * x_pos
            gx_neg = c_neg[..., None] * x_neg
        # x = neg + r - t (head corrupted) or h + r - neg (tail corrupted)
        grad_h = gx_pos + torch.where(ch, zero, gx_neg).sum(1)
        grad_r = gx_pos + gx_neg.sum(1)
        grad_t = -gx_pos - torch.where(ch, gx_neg, zero).sum(1)
        grad_neg = torch.where(ch, gx_neg, -gx_neg)
    elif model == "distmult":
        rt, hr = r * t, h * r
        grad_h = gp * rt + torch.where(
            ch, zero, gn * (r[:, None, :] * neg)).sum(1)
        grad_r = gp * (h * t) + torch.where(
            ch, gn * (neg * t[:, None, :]), gn * (h[:, None, :] * neg)).sum(1)
        grad_t = gp * hr + torch.where(
            ch, gn * (neg * r[:, None, :]), zero).sum(1)
        grad_neg = torch.where(ch, gn * rt[:, None, :], gn * hr[:, None, :])
    else:
        raise ValueError(model)
    return grad_h, grad_r, grad_t, grad_neg


# ---------------------------- swa_attention ---------------------------- #
def _swa_logits(q: torch.Tensor, k: torch.Tensor, window: int,
                q_offset: int):
    """Scaled fp32 scores (B, Hkv, G, Sq, Skv), -inf where key j is not
    visible to query i (``q_offset + i - window < j <= q_offset + i``)."""
    if q.is_cuda:
        no_tf32()
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    qf = q.float() * (d ** -0.5)
    qf = qf.reshape(b, hkv, hq // hkv, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
    return logits.masked_fill(~mask, float("-inf"))


def swa_attention_ref(
    q: torch.Tensor,      # (B, Hq, Sq, d)
    k: torch.Tensor,      # (B, Hkv, Skv, d)
    v: torch.Tensor,      # (B, Hkv, Skv, d)
    window: int,          # attend to positions in (pos - window, pos]
    q_offset: int = 0,    # absolute position of q[..., 0, :] (decode: Skv-Sq)
) -> torch.Tensor:
    """Causal sliding-window GQA attention, fp32 softmax. (B, Hq, Sq, d).
    A copy of ``repro.kernels.ref.swa_attention_ref``."""
    b, hq, sq, d = q.shape
    probs = torch.softmax(_swa_logits(q, k, window, q_offset), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def swa_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, window: int,
                          q_offset: int = 0) -> torch.Tensor:
    """(B, Hq, Sq) fp32: each query's log-sum-exp of its scaled scores over
    the keys it sees, ``-inf`` for a query that sees none (what the
    kernel's forward saves for the backward)."""
    b, hq, sq, _ = q.shape
    lse = torch.logsumexp(_swa_logits(q, k, window, q_offset), dim=-1)
    return lse.reshape(b, hq, sq)


def swa_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor,
                               window: int, q_offset: int = 0):
    """The gradient of :func:`swa_attention_ref` given its output ``o``, its
    log-sum-exp ``lse`` (B, Hq, Sq) and the output's gradient ``do``, by
    the explicit formulas in fp32 (the kernel's, ``swa_attention.cu``)::

        P = exp(scale q k^T - lse) on visible pairs, D = rowsum(dO * O)
        dS = P * (dO v^T - D)
        dV = sum over the kv row's q heads of P^T dO
        dK = scale * sum of dS^T q,   dQ = scale * dS k

    Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5
    lse = lse.float().reshape(b, hkv, g, sq, 1)
    # a query that sees no key has lse = -inf and no visible pair: 0 keeps
    # its p at exp(-inf) = 0 instead of nan
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(_swa_logits(q, k, window, q_offset) - lse)
    dof = do.float().reshape(b, hkv, g, sq, d)
    dvec = (dof * o.float().reshape(b, hkv, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float()) - dvec)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(b, hkv, g, sq, d)) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------- selective_scan --------------------------- #
def selective_scan(h0: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan over one chunk, step by step in fp32: the
    contract of ``repro.models.blocks._selective_scan_chunk`` (which runs
    a log-depth associative scan instead).

    h0 (B, d_in, st) fp32; dt (B, c, d_in); Bm, Cm (B, c, st); A (d_in,
    st) fp32; xc (B, c, d_in).  For each step t::

        h = exp(dt_t * A) * h + (dt_t * x_t) B_t,   y_t = <h, C_t>

    Returns ``(h_last (B, d_in, st), y (B, c, d_in))``, both fp32.
    Differentiable (autograd through the steps)."""
    dtf, xf = dt.float(), xc.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = h0.float()
    ys = []
    for t in range(dtf.shape[1]):
        d = dtf[:, t, :, None]                                # (B, d_in, 1)
        h = torch.exp(d * A) * h + (d * xf[:, t, :, None]) * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else dtf.new_zeros(dtf.shape)
    return h, y


def selective_scan_fused(h0: Optional[torch.Tensor], dt: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor,
                         xc: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                         dt_bias: torch.Tensor, chunk: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Mamba layer's tail around the scan, in the reference's order
    (``repro.models.blocks.mamba_apply``): dt's bias (added in dt's dtype,
    as ``layers.dense`` adds it), softplus in fp32, :func:`selective_scan`
    over ``chunk`` steps at a time from ``h0`` (zeros when None), the D
    skip and the silu(z) gate in fp32, cast back to xc's dtype.

    Returns ``(h_last (B, d_in, st) fp32, out (B, S, d_in) in xc's
    dtype)``.  Differentiable."""
    dtf = F.softplus((dt + dt_bias).float())
    B, S, d_in = xc.shape
    h = torch.zeros((B, d_in, A.shape[1]), dtype=torch.float32,
                    device=xc.device) if h0 is None else h0.float()
    c = min(chunk, S)
    ys = []
    for t0 in range(0, S, c):
        cut = slice(t0, t0 + c)
        h, y = selective_scan(h, dtf[:, cut], Bm[:, cut], Cm[:, cut], A,
                              xc[:, cut])
        ys.append(y)
    y = torch.cat(ys, dim=1) + D * xc.float()
    return h, (y * F.silu(z.float())).to(xc.dtype)
