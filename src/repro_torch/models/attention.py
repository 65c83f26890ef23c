"""Attention for the model zoo: the port of ``repro.models.attention``.

Layout convention (the "grouped-MHA" view used everywhere):

    q        (B, Sq, G, H, hd)   G = cfg.groups KV slots, H = heads/slot
    k, v     (B, Sk, G, hd)
    output   (B, Sq, G, H, hd)

Four paths, all accumulating in fp32:
  * ``swa_attention``      — sliding-window train/prefill: the CUDA kernels
    ``kernels/csrc/swa_attention.cu`` on the card, their plain versions on
    the CPU (``kernels/swa_attention.py`` decides by the tensor's device):
    the no-grad forward for prefill, ``SWAAttentionFn`` (forward with the
    log-sum-exp, backward kernels) when a gradient is wanted.
    Heads fold as (B, G, H), so kernel kv row = q row // H = b * G + g.
    The kernel scales the fp32 scores (the Pallas kernel's rounding); the
    reference's jnp scan scales q in q's dtype first.  Both round p to the
    value dtype before P.V.  In fp32 the two agree to rounding.
  * ``chunked_attention``  — train/prefill with full attention, causal or
    not: nested loops over q-chunks x kv-chunks with an online softmax.
  * ``plain_attention``    — unchunked, for short sequences.
  * ``decode_attention``   — single-token decode against a KV cache
    (optionally a rolling buffer for SWA).
The last three are plain PyTorch, as the reference computes them outside
any Pallas kernel.  Where the reference asks for fp32 products of
low-precision inputs (``preferred_element_type``), the operands are cast
to fp32 first: bf16 products are exact in fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import swa_attention as swa_kernels

NEG = -1e30


def _scale(hd: int, dtype) -> torch.Tensor:
    """``1 / sqrt(hd)`` as the reference forms it: the square root in fp32,
    rounded to the model's dtype, then inverted in that dtype."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd))).to(dtype)


def _online_update(carry, s: torch.Tensor, vj: torch.Tensor):
    """One flash-attention accumulator update.

    carry = (m, l, acc): (B,G,H,cq), (B,G,H,cq), (B,G,H,cq,hd)
    s:   (B,G,H,cq,ck) masked scores (NEG where disallowed)
    vj:  (B,ck,G,hd)
    """
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(-1))
    # rows that are still fully masked keep m at NEG; exp(s - m) would be
    # exp(0) = 1 for masked entries, so zero them explicitly
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= NEG / 2, 0.0, p)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    pv = torch.einsum("bghqk,bkgd->bghqd", p.to(vj.dtype).float(), vj.float())
    acc = acc * alpha[..., None] + pv
    return m_new, l, acc


def _finish(m, l, acc, dtype) -> torch.Tensor:
    out = torch.where(l[..., None] > 0,
                      acc / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out.to(dtype)  # (B,G,H,cq,hd)


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[axis]
    pad = -n % mult
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return x, n


def chunked_attention(
    q: torch.Tensor,           # (B, Sq, G, H, hd)
    k: torch.Tensor,           # (B, Sk, G, hd)
    v: torch.Tensor,           # (B, Sk, G, hd)
    *,
    causal: bool = True,
    q_offset: int = 0,         # absolute position of q[0] (cross-chunk causal)
    chunk_q: int = 512,
    chunk_kv: int = 512,
) -> torch.Tensor:
    B, Sq, G, H, hd = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk_q, Sq), min(chunk_kv, Sk)
    dev = q.device

    q, Sq0 = _pad_to(q * _scale(hd, q.dtype), 1, cq)
    k, Sk0 = _pad_to(k, 1, ck)
    v, _ = _pad_to(v, 1, ck)
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    rows = torch.arange(cq, device=dev)
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq].float()                 # (B,cq,G,H,hd)
        q_pos = q_offset + i * cq + rows                        # (cq,)
        m = torch.full((B, G, H, cq), NEG, device=dev)
        l = torch.zeros((B, G, H, cq), device=dev)
        acc = torch.zeros((B, G, H, cq, hd), device=dev)
        for j in range(nk):
            kj = k[:, j * ck:(j + 1) * ck]
            vj = v[:, j * ck:(j + 1) * ck]
            s = torch.einsum("bqghd,bkgd->bghqk", qi, kj.float())
            k_pos = j * ck + torch.arange(ck, device=dev)
            ok = (k_pos[None, :] < Sk0) & (rows[:, None] + i * cq < Sq0)
            if causal:
                ok &= k_pos[None, :] <= q_pos[:, None]
            s = torch.where(ok, s, NEG)
            m, l, acc = _online_update((m, l, acc), s, vj)
        out = _finish(m, l, acc, q.dtype)                      # (B,G,H,cq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))                # (B,cq,G,H,hd)
    return torch.cat(outs, dim=1)[:, :Sq0]


def swa_attention(
    q: torch.Tensor,           # (B, Sq, G, H, hd)
    k: torch.Tensor,           # (B, Sk, G, hd)  (Sk == Sq for train/prefill)
    v: torch.Tensor,
    *,
    window: int,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal sliding-window attention: position i attends (i-window, i].

    Runs in ``kernels/csrc/swa_attention.cu`` on the card; the kernels visit
    only the key tiles inside each query tile's window: cost O(S * W).
    With grad enabled and an input that wants one, the call goes through
    ``SWAAttentionFn``, whose gradients flow back to q, k and v through the
    fold's permutes and copies; otherwise (prefill, under ``no_grad``) it
    is one forward launch a layer, with no log-sum-exp.

    ``q_offset`` has the kernel's meaning (and ``chunked_attention``'s):
    ``q[:, i]`` sits at position ``q_offset + i`` and ``k[:, j]`` at ``j``.
    The reference's jnp scan shifts both by ``q_offset`` instead, and with
    ``q_offset > 0`` lets its zero front-padding into the softmax of the
    first ``window - 1`` queries; every caller in either package passes 0.
    """
    B, Sq, G, H, hd = q.shape
    Sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * G * H, Sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * G, Sk, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * G, Sk, hd).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = swa_kernels.SWAAttentionFn.apply(qf, kf, vf, window, q_offset)
    else:
        out = swa_kernels.swa_attention_forward(qf, kf, vf, window, q_offset)
    return out.reshape(B, G, H, Sq, hd).permute(0, 3, 1, 2, 4)


def plain_attention(
    q: torch.Tensor,           # (B, Sq, G, H, hd)
    k: torch.Tensor,           # (B, Sk, G, hd)
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset: int = 0,
) -> torch.Tensor:
    """Unchunked attention — for short decoder/cross-attn sequences."""
    B, Sq, G, H, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqghd,bkgd->bghqk", (q * _scale(hd, q.dtype)).float(),
                     k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        ok = torch.arange(Sk, device=q.device)[None, :] <= q_pos[:, None]
        s = torch.where(ok, s, NEG)
    m = s.amax(-1)
    p = torch.where(s <= NEG / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(-1)
    pv = torch.einsum("bghqk,bkgd->bghqd", p.to(v.dtype).float(), v.float())
    out = _finish(m, l, pv, q.dtype)
    return out.permute(0, 3, 1, 2, 4)


def decode_attention(
    q: torch.Tensor,           # (B, 1, G, H, hd)
    k_cache: torch.Tensor,     # (B, G, S, hd)  (post-RoPE keys)
    v_cache: torch.Tensor,     # (B, G, S, hd)
    n_valid: int,              # number of valid cache slots
) -> torch.Tensor:
    """One-token decode. For rolling (SWA) caches the caller passes
    n_valid = min(pos+1, window); slot order is irrelevant because keys are
    stored post-RoPE."""
    B, _, G, H, hd = q.shape
    S = k_cache.shape[2]
    s = torch.einsum("bqghd,bgkd->bghqk", (q * _scale(hd, q.dtype)).float(),
                     k_cache.float())                       # (B,G,H,1,S)
    ok = torch.arange(S, device=q.device) < n_valid
    s = torch.where(ok, s, NEG)
    m = s.amax(-1)
    p = torch.where(s <= NEG / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(-1)
    pv = torch.einsum("bghqk,bgkd->bghqd", p.to(v_cache.dtype).float(),
                      v_cache.float())
    out = _finish(m, l, pv, q.dtype)
    return out.permute(0, 3, 1, 2, 4)                        # (B,1,G,H,hd)
