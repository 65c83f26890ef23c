"""Layer blocks for the dense family: the port of the attention and
transformer-block part of ``repro.models.blocks``.

Every block is a pair ``*_init(gen, cfg) -> params dict`` and
``*_apply(p, x, cfg, ...) -> y`` on the residual stream (B, S, d), where
``p`` is the block's :class:`~repro_torch.models.layers.ParamTree` (or the
dict ``*_init`` returned).  Decode variants take an explicit cache.

The attention block is GQA in the grouped-MHA view (``config.padded_heads``
/ kv repeated to ``cfg.groups``), full or sliding-window, with RoPE.
Sliding-window prefill runs the CUDA kernel through
:func:`repro_torch.models.attention.swa_attention`.

Decode writes the new slot into the caller's cache in place (the JAX
package re-emits the cache).  The int8 KV cache and the MoE, Mamba and
RG-LRU blocks are not ported yet (ROADMAP, Queue 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import chunked_attention, decode_attention, swa_attention
from .config import ArchConfig
from .layers import (Gen, apply_norm, dense, dense_init, init_device, mlp,
                     mlp_init, norm_init, rope_qk)


# ===================================================================== #
# Attention block
# ===================================================================== #
def attn_init(gen: Gen, cfg: ArchConfig) -> dict:
    d, hd, kv = cfg.d_model, cfg.hd, cfg.n_kv_heads
    hp = cfg.padded_heads()
    dt = cfg.jdtype
    p = {
        "wq": dense_init(gen, d, hp * hd, dt, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, kv * hd, dt, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, kv * hd, dt, bias=cfg.qkv_bias),
        "wo": dense_init(gen, hp * hd, d, dt),
    }
    # zero the padding q-heads: their q columns and out-proj rows. Forward
    # is then exactly the published n_heads model.
    if hp != cfg.n_heads:
        mask = _pad_head_mask(cfg).to(init_device(gen))   # (hp,) 1=real 0=pad
        colmask = mask.repeat_interleave(hd)[None, :].to(dt)
        p["wq"]["w"] = p["wq"]["w"] * colmask
        if "b" in p["wq"]:
            p["wq"]["b"] = p["wq"]["b"] * colmask[0]
        p["wo"]["w"] = p["wo"]["w"] * colmask.T
    return p


def _pad_head_mask(cfg: ArchConfig) -> torch.Tensor:
    """(hp,) mask — q-heads are laid out in n_kv_heads groups of g' slots,
    the first g real heads of each group are live."""
    g = cfg.n_heads // cfg.n_kv_heads
    gp = cfg.padded_heads() // cfg.n_kv_heads
    m = torch.zeros((cfg.n_kv_heads, gp))
    m[:, :g] = 1.0
    return m.reshape(-1)


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig):
    """x (B,S,d) -> q (B,S,G,H,hd), k/v (B,S,G,hd) with KV repeated to G."""
    B, S, _ = x.shape
    hd, G = cfg.hd, cfg.groups
    hp, kv = cfg.padded_heads(), cfg.n_kv_heads
    q = dense(p["wq"], x).reshape(B, S, G, hp // G, hd)
    k = dense(p["wk"], x).reshape(B, S, kv, hd)
    v = dense(p["wv"], x).reshape(B, S, kv, hd)
    if G != kv:
        r = G // kv
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    return q, k, v


def _positions(start: int, n: int, device) -> torch.Tensor:
    # arange on the device: no host-to-device copy, so decode never waits
    return torch.arange(start, start + n, device=device)


def attn_apply(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0
               ) -> torch.Tensor:
    """Train/prefill attention over full sequence x (B,S,d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta > 0:
        pos = _positions(q_offset, S, x.device)
        q, k = rope_qk(q, k, pos, pos, cfg.rope_theta)
    if window is not None:
        o = swa_attention(q, k, v, window=window, q_offset=q_offset)
    elif causal:
        o = chunked_attention(q, k, v, causal=True, q_offset=q_offset)
    else:
        o = chunked_attention(q, k, v, causal=False)
    return dense(p["wo"], o.reshape(B, S, -1))


def attn_prefill(p, x: torch.Tensor, cfg: ArchConfig, *,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like attn_apply but also returns the (post-RoPE) KV for the cache.

    Returns (out (B,S,d), k_cache (B,G,Sc,hd), v_cache (B,G,Sc,hd)) where
    Sc = window for SWA (rolling layout: slot = pos % window) else S.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta > 0:
        pos = _positions(0, S, x.device)
        q, k = rope_qk(q, k, pos, pos, cfg.rope_theta)
    if window is not None:
        o = swa_attention(q, k, v, window=window)
        W = window
        if S >= W:
            # last W positions, laid out rolling: slot i holds pos p with
            # p % W == i. Positions S-W..S-1 -> roll so slot (p % W).
            shift = (S - W) % W
            kc = torch.roll(k[:, S - W:], shift, dims=1)
            vc = torch.roll(v[:, S - W:], shift, dims=1)
        else:
            pad = (0, 0, 0, 0, 0, W - S)
            kc = torch.nn.functional.pad(k, pad)
            vc = torch.nn.functional.pad(v, pad)
    else:
        o = chunked_attention(q, k, v, causal=True)
        kc, vc = k, v
    o = dense(p["wo"], o.reshape(B, S, -1))
    return o, kc.movedim(1, 2), vc.movedim(1, 2)


def _project_one(p, x: torch.Tensor, pos: int, cfg: ArchConfig):
    q, k, v = _project_qkv(p, x, cfg)                 # q (B,1,G,H,hd)
    if cfg.rope_theta > 0:
        ppos = _positions(pos, 1, x.device)
        q, k = rope_qk(q, k, ppos, ppos, cfg.rope_theta)
    return q, k[:, 0], v[:, 0]                        # k, v (B,G,hd)


def attn_decode(p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: int, cfg: ArchConfig, *,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode. x (B,1,d); caches (B,G,Sc,hd); pos an int.

    Writes the new KV at slot (pos % window) for SWA, pos otherwise, into
    the caches in place, then attends over valid slots.  Returns
    (out (B,1,d), k_cache, v_cache).
    """
    B = x.shape[0]
    q, k, v = _project_one(p, x, pos, cfg)
    Sc = k_cache.shape[2]
    slot = pos % Sc if window is not None else pos
    k_cache[:, :, slot] = k.to(k_cache.dtype)
    v_cache[:, :, slot] = v.to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, min(pos + 1, Sc))
    return dense(p["wo"], o.reshape(B, 1, -1)), k_cache, v_cache


def attn_decode_inplace(p, x: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, layer: int, pos: int,
                        cfg: ArchConfig, *, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like attn_decode but on the STACKED (L, B, G, S, hd) caches: writes
    the one (B, G, hd) slot at (layer, :, :, slot) and attends over that
    layer's rows."""
    B = x.shape[0]
    q, k, v = _project_one(p, x, pos, cfg)
    Sc = k_cache.shape[3]
    slot = pos % Sc if window is not None else pos
    k_cache[layer, :, :, slot] = k.to(k_cache.dtype)
    v_cache[layer, :, :, slot] = v.to(v_cache.dtype)
    o = decode_attention(q, k_cache[layer], v_cache[layer], min(pos + 1, Sc))
    return dense(p["wo"], o.reshape(B, 1, -1)), k_cache, v_cache


# ===================================================================== #
# Transformer block (attention + MLP), dense-family
# ===================================================================== #
def block_init(gen: Gen, cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "attn": attn_init(gen, cfg),
        "ln2": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.jdtype, cfg.act),
    }


def block_apply(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
                window: Optional[int] = None) -> torch.Tensor:
    x = x + attn_apply(p["attn"], apply_norm(p["ln1"], x), cfg,
                       causal=causal, window=window)
    return x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.act)


def block_prefill(p, x: torch.Tensor, cfg: ArchConfig, *,
                  window: Optional[int] = None):
    a, kc, vc = attn_prefill(p["attn"], apply_norm(p["ln1"], x), cfg,
                             window=window)
    x = x + a
    x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.act)
    return x, kc, vc


def block_decode(p, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: int, cfg: ArchConfig, *, window: Optional[int] = None):
    a, kc, vc = attn_decode(p["attn"], apply_norm(p["ln1"], x), kc, vc, pos,
                            cfg, window=window)
    x = x + a
    x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.act)
    return x, kc, vc
