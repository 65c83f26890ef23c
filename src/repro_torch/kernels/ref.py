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
#: torch.nn.functional.softplus's default threshold: above it, x itself
#: (and a gradient of 1); the kernels take the same
SOFTPLUS_THRESHOLD = 20.0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the scan's working dtype: fp32, or fp64 for fp64 inputs
    (the tests' high-precision runs; the kernels take fp32 and bf16)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def selective_scan(h0: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba's selective scan over one chunk, step by step in fp32: the
    contract of ``repro.models.blocks._selective_scan_chunk`` (which runs
    a log-depth associative scan instead).

    h0 (B, d_in, st) fp32; dt (B, c, d_in); Bm, Cm (B, c, st); A (d_in,
    st) fp32; xc (B, c, d_in).  For each step t::

        h = exp(dt_t * A) * h + (dt_t * x_t) B_t,   y_t = <h, C_t>

    Returns ``(h_last (B, d_in, st), y (B, c, d_in))``, both fp32 (fp64
    for fp64 dt).  Differentiable (autograd through the steps)."""
    dtf, xf = _wide(dt), _wide(xc)
    Bf, Cf = _wide(Bm).to(dtf.dtype), _wide(Cm).to(dtf.dtype)
    h = h0.to(dtf.dtype)
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
    dtype)``.  Differentiable; its gradient written out is
    :func:`selective_scan_fused_backward`."""
    dtf = F.softplus(_wide(dt + dt_bias))
    B, S, d_in = xc.shape
    h = torch.zeros((B, d_in, A.shape[1]), dtype=dtf.dtype,
                    device=xc.device) if h0 is None else h0.to(dtf.dtype)
    c = min(chunk, S)
    ys = []
    for t0 in range(0, S, c):
        cut = slice(t0, t0 + c)
        h, y = selective_scan(h, dtf[:, cut], Bm[:, cut], Cm[:, cut], A,
                              xc[:, cut])
        ys.append(y)
    y = torch.cat(ys, dim=1) + D * _wide(xc)
    return h, (y * F.silu(_wide(z))).to(xc.dtype)


def selective_scan_fused_backward(
        h0: Optional[torch.Tensor], dt: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor,
        D: torch.Tensor, z: torch.Tensor, dt_bias: torch.Tensor,
        dout: torch.Tensor, dh_last: Optional[torch.Tensor] = None
        ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of :func:`selective_scan_fused` given ``dout`` (B, S,
    d_in), the gradient of ``out``, and ``dh_last`` (B, d_in, st), that of
    ``h_last`` (None: zero), by an explicit reverse loop in fp32 (no
    autograd): the contract of ``csrc/selective_scan.cu``'s backward.

    With v = dt + bias (rounded in the model dtype), dtf = softplus(v),
    a_t = exp(dtf_t A), h_t = a_t h_{t-1} + dtf_t x_t B_t, y_t = <h_t,
    C_t>, out_t = (y_t + D x_t) silu(z_t) and g = dout silu(z)::

        dz     = dout (y + D x) silu'(z),  silu'(z) = s (1 + z (1 - s))
        dD     = sum g x,                  dx = g D + ...
        dh_t   = C_t g_t + a_{t+1} dh_{t+1}   from dh_S = dh_last
        dC_t   = sum over channels of g_t h_t
        dB_t   = sum over channels of dh_t dtf_t x_t
        dx_t  += sum over states of dh_t dtf_t B_t
        ddtf_t = sum over states of dh_t (A a_t h_{t-1} + B_t x_t)
        dA     = sum over (b, t) of dh_t dtf_t a_t h_{t-1}
        dh0    = a_0 dh_0

    and ddt = ddtf softplus'(v): sigmoid(v), or 1 past the threshold of
    20 (the rounding of v passes the gradient as it is), ddt_bias the
    sum of ddt over (b, t) in fp32.  Returns ``(dh0, ddt, dBm, dCm, dA,
    dxc, dD, dz, ddt_bias)`` in the order of the forward's arguments:
    ddt, dxc, dz and ddt_bias in the model dtype, dBm and dCm in theirs,
    dA, dD and dh0 fp32 (dh0 None when h0 is None)."""
    v = _wide(dt + dt_bias)
    wd = v.dtype
    dtf = F.softplus(v)
    dsp = torch.where(v > SOFTPLUS_THRESHOLD, torch.ones_like(v),
                      torch.sigmoid(v))
    xf, zf, do = _wide(xc), _wide(z), _wide(dout)
    Bf, Cf = _wide(Bm).to(wd), _wide(Cm).to(wd)
    Af, Df = A.to(wd), D.to(wd)
    B, S, d_in = xf.shape
    h = torch.zeros((B, d_in, A.shape[1]), dtype=wd, device=xf.device) \
        if h0 is None else h0.to(wd)
    # the forward, keeping every state: hs[t] = h_{t-1}, hs[S] = h_{S-1}
    hs = [h]
    y = torch.empty_like(xf)
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + (dtf[:, t, :, None] * xf[:, t, :, None]) * Bf[:, t, None, :]
        hs.append(h)
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    s = torch.sigmoid(zf)
    g = do * (zf * s)
    dz = do * (y + Df * xf) * (s * (1 + zf * (1 - s)))
    dD = (g * xf).sum((0, 1))
    dx = g * Df
    ddtf = torch.empty_like(xf)
    dBm = torch.empty_like(Bf)
    dCm = torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    dh = torch.zeros_like(h) if dh_last is None else dh_last.to(wd).clone()
    for t in reversed(range(S)):
        d = dtf[:, t, :, None]                                # (B, d_in, 1)
        xt = xf[:, t, :, None]
        Bt, Ct = Bf[:, t, None, :], Cf[:, t, None, :]         # (B, 1, st)
        a = torch.exp(d * Af)
        dh = dh + Ct * g[:, t, :, None]
        dCm[:, t] = (g[:, t, :, None] * hs[t + 1]).sum(1)
        dBm[:, t] = (dh * (d * xt)).sum(1)
        dx[:, t] += (dh * Bt).sum(-1) * dtf[:, t]
        ddtf[:, t] = (dh * (Af * a * hs[t] + Bt * xt)).sum(-1)
        dA += (dh * d * a * hs[t]).sum(0)
        dh = a * dh
    ddt = ddtf * dsp
    return (None if h0 is None else dh.to(torch.promote_types(
                h0.dtype, torch.float32)),
            ddt.to(dt.dtype), dBm.to(Bm.dtype), dCm.to(Cm.dtype),
            dA.to(A.dtype), dx.to(xc.dtype), dD.to(D.dtype),
            dz.to(z.dtype), ddt.sum((0, 1)).to(dt_bias.dtype))
