"""Layer blocks: the port of ``repro.models.blocks`` (attention, the
transformer block, MoE, Mamba and the RG-LRU).

Every block is a pair ``*_init(gen, cfg) -> params dict`` and
``*_apply(p, x, cfg, ...) -> y`` on the residual stream (B, S, d), where
``p`` is the block's :class:`~repro_torch.models.layers.ParamTree` (or the
dict ``*_init`` returned).  Decode variants take an explicit cache.

The attention block is GQA in the grouped-MHA view (``config.padded_heads``
/ kv repeated to ``cfg.groups``), full or sliding-window, with RoPE.
Causal prefill and training attention, sliding-window or full, run the
CUDA kernel through :func:`repro_torch.models.attention.swa_attention`:
full causal attention is the band of a window that covers every key
(``window = max(Sk, q_offset + Sq)``), where the reference runs its jnp
``chunked_attention``.  Non-causal attention stays plain.

Decode writes the new slot into the caller's cache in place (the JAX
package re-emits the cache), optionally into an int8 cache with per-slot
fp32 scales (``quantize_kv``).

Under a model axis of n (``runtime.tp_group``: a process mesh that cuts
the weights, ``sharding.TP_FAMILIES``) each rank runs its ``G / n`` KV
slots and their ``padded_heads() / n`` q heads (``wq`` / ``wk`` / ``wv``
cut by output, ``wo`` by input: a padding head's zero rows sit with its
head), its cache ``(B, G / n, Sc, hd)`` a layer; the normed input enters
through ``runtime.pvary`` and one ``all_reduce`` after ``wo`` sums the
heads.
RoPE, the window and the rolling cache are per slot, so unchanged.

The MoE block is the reference's capacity-dropped top-k dispatch
(``moe_apply``): plain PyTorch, as the reference computes it outside any
Pallas kernel.  Under a process mesh (``runtime.use_mesh``) with
``cfg.moe_impl == "shard_map"`` it is the explicit expert-parallel
``moe_apply_shard_map``: each model rank holds its experts and one
``all_reduce`` a layer sums their outputs.

The Mamba block (mamba1) keeps the reference's projections, causal conv
and dtype order; its softplus, selective scan, D skip and gate run in
``kernels/csrc/selective_scan.cu`` on the card, one launch a layer over
the whole sequence, and their plain version chunk by chunk on the CPU, as
the reference scans.  Trained, the same call goes through
``SelectiveScanFusedFn``: on the card the forward also saves each tile's
starting state and the backward kernel gives every input's gradient,
which autograd carries to in_proj's and x_proj's outputs through the
views z, Bm and Cm are.

Under a model axis of n both recurrences are channel-parallel (the
reference's ``param_pspec``): the input projections are cut by output,
the conv and the recurrence's own params by channel, the output
projection by input and followed by one ``all_reduce``; the scan runs on
the rank's ``d_in / n`` (Mamba) or ``w / n`` (RG-LRU) channels with no
collective inside it.  Mamba's ``x_proj`` contracts the rank's channels
too (one more ``all_reduce``); the RG-LRU's gate matmuls read every
channel of xc, all-gathered once a layer.

The RG-LRU block (recurrentgemma) keeps the reference's dtype order: the
gates in fp32, the conv without silu, ``y`` cast to the model's dtype
before the gelu gate.  Its diagonal recurrence has no kernel (the
reference scans it in jnp too): :func:`_rglru_scan` runs a log-depth
scan within every 256-step chunk at once and carries the state across
the chunks in a loop, and autograd differentiates it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import selective_scan as scan_kernels
from . import runtime
from .attention import chunked_attention, decode_attention, swa_attention
from .config import ArchConfig
from .layers import (Gen, apply_norm, dense, dense_init, init_device, mlp,
                     mlp_init, norm_init, normal, rope_qk, row_dense)


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


def project_kv(p, x: torch.Tensor, cfg: ArchConfig, group
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> k/v (B,S,G,hd), KV repeated to G; with a process
    ``group`` of n, the rank's G/n slots, x having entered through
    ``runtime.pvary`` (the caller's: q reads it too).  Where
    ``n_kv_heads % n != 0`` a rank's slots read head columns another rank
    holds: the projected K / V are gathered
    (``runtime.gather_last_summed``), then the rank's slots taken."""
    B, S, _ = x.shape
    hd, G, kv = cfg.hd, cfg.groups, cfg.n_kv_heads
    n, i = (1, 0) if group is None else runtime.group_index(group)
    k, v = dense(p["wk"], x), dense(p["wv"], x)
    if kv % n:
        k, v = (runtime.gather_last_summed(t, group) for t in (k, v))
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if G != kv:
        r = G // kv
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    if kv % n:
        k, v = (t[:, :, i * G // n:(i + 1) * G // n] for t in (k, v))
    return k, v


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, group):
    """x (B,S,d) -> q (B,S,G,H,hd), k/v (B,S,G,hd) (:func:`project_kv`);
    with a process ``group`` of n, the rank's G/n slots."""
    B, S, _ = x.shape
    n = 1 if group is None else runtime.group_index(group)[0]
    if group is not None:
        x = runtime.pvary(x, group)
    q = dense(p["wq"], x).reshape(B, S, cfg.groups // n,
                                  cfg.heads_per_group, cfg.hd)
    k, v = project_kv(p, x, cfg, group)
    return q, k, v


def _positions(start: int, n: int, device) -> torch.Tensor:
    # arange on the device: no host-to-device copy, so decode never waits
    return torch.arange(start, start + n, device=device)


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: int) -> torch.Tensor:
    """Full causal attention on the SWA kernel: with a window that covers
    every key, ``q_offset + i - W < j`` holds for every key ``j >= 0``, so
    the band is ``chunked_attention(causal=True)``'s mask."""
    window = max(k.shape[1], q_offset + q.shape[1])
    return swa_attention(q, k, v, window=window, q_offset=q_offset)


def attn_apply(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
               window: Optional[int] = None, q_offset: int = 0
               ) -> torch.Tensor:
    """Train/prefill attention over full sequence x (B,S,d)."""
    B, S, _ = x.shape
    group = runtime.tp_group(cfg)
    q, k, v = _project_qkv(p, x, cfg, group)
    if cfg.rope_theta > 0:
        pos = _positions(q_offset, S, x.device)
        q, k = rope_qk(q, k, pos, pos, cfg.rope_theta)
    if window is not None:
        o = swa_attention(q, k, v, window=window, q_offset=q_offset)
    elif causal:
        o = _causal_attention(q, k, v, q_offset)
    else:
        o = chunked_attention(q, k, v, causal=False)
    return row_dense(p["wo"], o.reshape(B, S, -1), group)


def attn_prefill(p, x: torch.Tensor, cfg: ArchConfig, *,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like attn_apply but also returns the (post-RoPE) KV for the cache.

    Returns (out (B,S,d), k_cache (B,G,Sc,hd), v_cache (B,G,Sc,hd)) where
    Sc = window for SWA (rolling layout: slot = pos % window) else S.
    """
    B, S, _ = x.shape
    group = runtime.tp_group(cfg)
    q, k, v = _project_qkv(p, x, cfg, group)
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
        o = _causal_attention(q, k, v, 0)
        kc, vc = k, v
    o = row_dense(p["wo"], o.reshape(B, S, -1), group)
    return o, kc.movedim(1, 2), vc.movedim(1, 2)


def _project_one(p, x: torch.Tensor, pos: int, cfg: ArchConfig, group):
    q, k, v = _project_qkv(p, x, cfg, group)          # q (B,1,G,H,hd)
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
    group = runtime.tp_group(cfg)
    q, k, v = _project_one(p, x, pos, cfg, group)
    Sc = k_cache.shape[2]
    slot = pos % Sc if window is not None else pos
    k_cache[:, :, slot] = k.to(k_cache.dtype)
    v_cache[:, :, slot] = v.to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, min(pos + 1, Sc))
    return row_dense(p["wo"], o.reshape(B, 1, -1), group), k_cache, v_cache


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(..., slot) int8 quantization over the trailing hd
    axis: t (..., hd) -> (int8 (..., hd), scale fp32 (...,)).  The
    reference's arithmetic: amax in fp32, ``scale = max(amax, 1e-8) /
    127``, ``round(t / scale)`` half to even, clipped to [-127, 127]."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def attn_decode_inplace(p, x: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, layer: int, pos: int,
                        cfg: ArchConfig, *, window: Optional[int] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None):
    """Like attn_decode but on the STACKED (L, B, G, S, hd) caches: writes
    the one (B, G, hd) slot at (layer, :, :, slot) and attends over that
    layer's rows.

    int8 KV mode: when ``k_scale`` / ``v_scale`` (L, B, G, S) fp32 are
    given, the caches are int8; the new slot is quantized on write (its
    scale written beside it) and the layer's rows are dequantized to the
    model's dtype for the attention dot.  Returns (out (B, 1, d), k_cache,
    v_cache), then k_scale, v_scale in int8 mode."""
    B = x.shape[0]
    group = runtime.tp_group(cfg)
    q, k, v = _project_one(p, x, pos, cfg, group)
    Sc = k_cache.shape[3]
    slot = pos % Sc if window is not None else pos
    quant = k_scale is not None
    if quant:
        k, k_scale[layer, :, :, slot] = quantize_kv(k)
        v, v_scale[layer, :, :, slot] = quantize_kv(v)
    k_cache[layer, :, :, slot] = k.to(k_cache.dtype)
    v_cache[layer, :, :, slot] = v.to(v_cache.dtype)
    row_k, row_v = k_cache[layer], v_cache[layer]
    if quant:
        row_k = dequantize_kv(row_k, k_scale[layer], x.dtype)
        row_v = dequantize_kv(row_v, v_scale[layer], x.dtype)
    o = decode_attention(q, row_k, row_v, min(pos + 1, Sc))
    o = row_dense(p["wo"], o.reshape(B, 1, -1), group)
    if quant:
        return o, k_cache, v_cache, k_scale, v_scale
    return o, k_cache, v_cache


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
    return x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.act,
                   runtime.tp_group(cfg))


def block_prefill(p, x: torch.Tensor, cfg: ArchConfig, *,
                  window: Optional[int] = None):
    a, kc, vc = attn_prefill(p["attn"], apply_norm(p["ln1"], x), cfg,
                             window=window)
    x = x + a
    x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.act,
                runtime.tp_group(cfg))
    return x, kc, vc


def block_decode(p, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: int, cfg: ArchConfig, *, window: Optional[int] = None):
    a, kc, vc = attn_decode(p["attn"], apply_norm(p["ln1"], x), kc, vc, pos,
                            cfg, window=window)
    x = x + a
    x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.act,
                runtime.tp_group(cfg))
    return x, kc, vc


# ===================================================================== #
# MoE block
# ===================================================================== #
def _moe_dims(cfg: ArchConfig):
    """(E_virtual, ff_virtual, split). moe_ff_split=r slices each expert's
    ff into r column blocks => E*r virtual experts of ff/r each. down-proj
    halves sum, so dispatching a token to all r virtual slices of its
    routed expert computes exactly the original expert."""
    E, ff = cfg.moe.n_experts, cfg.d_ff
    r = max(1, cfg.moe_ff_split or 1)
    return E * r, ff // r, r


def moe_init(gen: Gen, cfg: ArchConfig) -> dict:
    d, E = cfg.d_model, cfg.moe.n_experts
    Ev, ffv, _ = _moe_dims(cfg)
    dt = cfg.jdtype
    sc = 1.0 / math.sqrt(d)
    scf = 1.0 / math.sqrt(cfg.d_ff)
    return {
        "router": normal(gen, (d, E), sc, dt),
        "gate": normal(gen, (Ev, d, ffv), sc, dt),
        "up": normal(gen, (Ev, d, ffv), sc, dt),
        "down": normal(gen, (Ev, ffv, d), scf, dt),
    }


def moe_route(p, x: torch.Tensor, cfg: ArchConfig,
              blocks: Optional[int] = None):
    """The router and the capacity ranking of ``moe_apply``, for x
    (B, S, d) in ``blocks`` blocks (default ``cfg.moe_dp_blocks``):
    returns ``(probs (nb, Tb, E0) fp32, w (nb, Tb*K) fp32, idx (nb, Tb,
    K), keep (nb, Tb*K) bool, slot (nb, Tb*K), C)`` with K and the expert
    ids over the virtual experts when ``moe_ff_split`` > 1.

    Top-k sends ties to the lower expert index (``jax.lax.top_k``'s
    order): a stable descending sort keeps equal probabilities in index
    order.  Each (token, slot) pair's rank in its expert's queue counts
    the pairs before it in token-major order, as the reference's
    cumulative sum over a one-hot does; pairs ranked past the capacity
    ``C`` go to the scratch row ``E * C``."""
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    Ev, _, r = _moe_dims(cfg)
    T = B * S
    nb = max(1, (cfg.moe_dp_blocks if blocks is None else blocks) or 1)
    if T % nb:
        nb = 1
    Tb = T // nb
    xb = x.reshape(nb, Tb, d)

    logits = (xb @ p["router"]).float()                      # (nb, Tb, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :K], idx[..., :K]                         # (nb, Tb, K)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    if r > 1:
        # dispatch to every ff-slice of the routed expert (slices sum)
        idx = (idx[..., None] * r + torch.arange(r, device=x.device)
               ).reshape(nb, Tb, K * r)
        w = w.repeat_interleave(r, dim=-1)
        E, K = Ev, K * r
    C = max(1, int(math.ceil(Tb * K / E * cfg.moe.capacity_factor)))

    flat_idx = idx.reshape(nb, Tb * K)
    # a stable sort by expert keeps each expert's pairs in token-major
    # order, so a pair's rank is its place in the sorted order less the
    # place where its expert's run starts (the same integers as the
    # one-hot cumsum, without a scan down Tb*K rows of E columns)
    by_expert, order = torch.sort(flat_idx, dim=1, stable=True)
    first = torch.searchsorted(by_expert, by_expert)
    place = torch.arange(Tb * K, device=x.device).expand(nb, -1)
    rank = torch.empty_like(flat_idx).scatter_(1, order, place - first)
    keep = rank < C
    slot = torch.where(keep, flat_idx * C + rank, E * C)     # drop -> scratch
    return probs, w.reshape(nb, Tb * K), idx, keep, slot, C


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig,
              drops: Optional[torch.Tensor] = None, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,d), aux_loss fp32 scalar). Capacity-dropped top-k
    MoE, block-local dispatch (``cfg.moe_dp_blocks`` blocks, each with its
    own capacity), step for step as the reference's ``moe_apply``: the
    router in the model's dtype widened to fp32, softmax, top-k and
    renormalised weights; the scatter of each kept (token, slot) pair's
    row into an (E*C + 1, d) buffer by ``index_add_`` (kept slots are
    unique, so only the discarded scratch row sums several rows); the
    gate / up / down products in the model's dtype; the combine gather
    times ``w * keep``; the Switch aux loss per block over the original
    experts.

    Under a process ``mesh`` (the reference's gspmd impl on a mesh) the
    rank holds every expert and runs its own tokens as ``moe_dp_blocks /
    n_dp`` blocks, the reference's block-local capacity when the batch is
    data-sharded, and ``aux`` is averaged over the data axes.  The
    reference's ``_moe_constraint`` (``src/repro/models/blocks.py:518-530``)
    only pins the dispatch buffer's layout for XLA's partitioner: its
    data part is this block-per-rank split, its expert part exists only
    in ``moe_apply_shard_map``; nothing else of it has a counterpart.

    ``drops``, a 0-dim int64 tensor on x's device, gains the number of
    dropped (token, slot) pairs, in place (no host sync)."""
    B, S, d = x.shape
    E0 = cfg.moe.n_experts
    E, _, r = _moe_dims(cfg)
    dp = blocks = None
    if mesh is not None:
        dp = runtime.data_group(mesh)
        blocks = max(1, (cfg.moe_dp_blocks or 1)
                     // (mesh.size // mesh.shape["model"]))
    probs, w, idx, keep, slot, C = moe_route(p, x, cfg, blocks)
    nb, K = slot.shape[0], idx.shape[-1]
    if drops is not None:
        drops += (~keep).sum()

    # each block's (E*C + 1, d) buffer, the blocks stacked on one axis
    src = x.reshape(nb, -1, d).repeat_interleave(K, dim=1)   # (nb, Tb*K, d)
    rows = E * C + 1
    at = slot + (torch.arange(nb, device=x.device) * rows)[:, None]
    buf = x.new_zeros((nb * rows, d)).index_add(0, at.reshape(-1),
                                                src.reshape(-1, d))
    h = buf.reshape(nb, rows, d)[:, :E * C].reshape(nb, E, C, d)

    g = F.silu(torch.einsum("becd,edf->becf", h, p["gate"]))
    u = torch.einsum("becd,edf->becf", h, p["up"])
    o = torch.einsum("becf,efd->becd", g * u, p["down"])

    out_rows = torch.cat([o.reshape(nb, E * C, d),
                          o.new_zeros((nb, 1, d))], dim=1)
    y = torch.gather(out_rows, 1, slot[..., None].expand(-1, -1, d))
    y = y * (w * keep)[..., None].to(x.dtype)                # combine
    y = y.reshape(nb, -1, K, d).sum(dim=2)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e, per block and
    # averaged, over the ORIGINAL experts (virtual ff-slices are a layout)
    top1 = idx[..., 0] // r if r > 1 else idx[..., 0]        # (nb, Tb)
    f = F.one_hot(top1, E0).float().mean(dim=1)
    pmean = probs.mean(dim=1)                                # (nb, E0)
    aux = E0 * (f * pmean).sum(-1).mean()
    if dp is not None:
        aux = runtime.pmean(aux, dp)
    return y.reshape(B, S, d), aux


def moe_apply_shard_map(p, x: torch.Tensor, cfg: ArchConfig, mesh,
                        drops: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit expert-parallel MoE (the reference's
    ``moe_apply_shard_map``, ``src/repro/models/blocks.py:380-488``) on
    a process mesh.  ``x`` is this rank's tokens: the caller shards the
    batch over the data axes when they divide it (``B % n_dp == 0 and
    B >= n_dp``, the reference's ``bspec``) and replicates it otherwise;
    every model rank holds the same tokens (the residual, replicated
    over ``"model"`` after the attention's ``all_reduce``).  ``p["gate"]`` / ``"up"`` /
    ``"down"`` hold this rank's ``E_local = Ev / n_model`` experts
    (``convert.shard_params``), ``p["router"]`` all of them.

    Every model rank routes its tokens identically (``moe_route``, one
    block: the capacity C comes from the local T), keeps the pairs bound
    for its own experts (``mine``), scatters them into an ``(E_local * C
    + 1, d)`` buffer, runs its experts and gathers back, other ranks'
    slots reading the zero scratch row; ``y * (w * mine)`` summed over K
    is its share of the output, and one ``all_reduce`` over ``"model"``
    (:func:`runtime.psum_identity_bwd`) the only collective.  The tokens
    and the router enter through :func:`runtime.pvary`, so the partial
    cotangents each rank's experts and slots give them are summed over
    ``"model"``: once, as the reference's transpose of its ``_pvary`` and
    of the invariant router sums them.  ``aux`` is the rank's Switch loss
    averaged over ``"model"`` and the data axes (``jax.lax.pmean``).

    ``drops`` gains the dropped pairs bound for this rank's experts; the
    sum over the model ranks is the drops of their tokens, and over the
    data ranks too when the batch is data-sharded."""
    B, S, d = x.shape
    E0 = cfg.moe.n_experts
    Ev, _, r = _moe_dims(cfg)
    n_model = mesh.shape["model"]
    assert Ev % n_model == 0, (Ev, n_model)
    E_local = Ev // n_model
    if p["gate"].shape[0] != E_local:
        raise ValueError(f"the rank holds {p['gate'].shape[0]} experts, want "
                         f"{E_local} (convert.shard_params cuts them)")
    group = mesh.group("model")
    xf = runtime.pvary(x, group)
    router = runtime.pvary(p["router"], group)
    probs, w, idx, keep, slot, C = moe_route({"router": router}, xf, cfg, 1)
    T, K = B * S, idx.shape[-1]
    first = mesh.index("model") * E_local            # this rank's experts
    local_e = idx.reshape(T * K) - first
    resident = (local_e >= 0) & (local_e < E_local)
    mine = keep[0] & resident
    if drops is not None:
        drops += (resident & ~keep[0]).sum()
    lslot = torch.where(mine, slot[0] - first * C, E_local * C)

    src = xf.reshape(T, d).repeat_interleave(K, dim=0)
    buf = x.new_zeros((E_local * C + 1, d)).index_add(0, lslot, src)
    h = buf[:E_local * C].reshape(E_local, C, d)
    g = F.silu(torch.einsum("ecd,edf->ecf", h, p["gate"]))
    u = torch.einsum("ecd,edf->ecf", h, p["up"])
    o = torch.einsum("ecf,efd->ecd", g * u, p["down"])

    out_rows = torch.cat([o.reshape(E_local * C, d), o.new_zeros((1, d))])
    y = out_rows[lslot] * (w[0] * mine)[:, None].to(x.dtype)
    y = runtime.psum_identity_bwd(y.reshape(T, K, d).sum(dim=1), group)

    top1 = idx[0, :, 0] // r if r > 1 else idx[0, :, 0]
    f = F.one_hot(top1, E0).float().mean(dim=0)
    aux = E0 * (f * probs[0].mean(dim=0)).sum()
    # over "model" and the data axes: every axis of a process mesh
    aux = runtime.pmean(aux, mesh.group(mesh.axis_names))
    return y.reshape(B, S, d), aux


def moe_dispatch(p, x: torch.Tensor, cfg: ArchConfig,
                 drops: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel ``moe_apply_shard_map`` when a process mesh is
    active (``runtime.use_mesh``) and ``cfg.moe_impl == "shard_map"``;
    ``moe_apply`` (on the mesh, when one is active) otherwise."""
    mesh = runtime.get_mesh()
    if mesh is not None and cfg.moe_impl == "shard_map":
        return moe_apply_shard_map(p, x, cfg, mesh, drops)
    return moe_apply(p, x, cfg, drops, mesh)


def moe_block_init(gen: Gen, cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "attn": attn_init(gen, cfg),
        "ln2": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "moe": moe_init(gen, cfg),
    }


def moe_block_apply(p, x: torch.Tensor, cfg: ArchConfig):
    x = x + attn_apply(p["attn"], apply_norm(p["ln1"], x), cfg, causal=True)
    y, aux = moe_dispatch(p["moe"], apply_norm(p["ln2"], x), cfg)
    return x + y, aux


def moe_block_prefill(p, x: torch.Tensor, cfg: ArchConfig,
                      drops: Optional[torch.Tensor] = None):
    a, kc, vc = attn_prefill(p["attn"], apply_norm(p["ln1"], x), cfg)
    x = x + a
    y, _ = moe_dispatch(p["moe"], apply_norm(p["ln2"], x), cfg, drops)
    return x + y, kc, vc


def moe_block_decode(p, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     pos: int, cfg: ArchConfig,
                     drops: Optional[torch.Tensor] = None):
    a, kc, vc = attn_decode(p["attn"], apply_norm(p["ln1"], x), kc, vc, pos,
                            cfg)
    x = x + a
    y, _ = moe_dispatch(p["moe"], apply_norm(p["ln2"], x), cfg, drops)
    return x + y, kc, vc


# ===================================================================== #
# Mamba (mamba1 selective-scan) block
# ===================================================================== #
def _mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dtr = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dtr, s.d_state, s.d_conv


def mamba_init(gen: Gen, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in, dtr, st, cw = _mamba_dims(cfg)
    dt = cfg.jdtype
    dev = init_device(gen)
    A = torch.arange(1, st + 1, dtype=torch.float32, device=dev)[None, :]
    return {
        "in_proj": dense_init(gen, d, 2 * d_in, dt),
        "conv_w": normal(gen, (cw, d_in), 1.0 / math.sqrt(cw), dt),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=dev),
        "x_proj": dense_init(gen, d_in, dtr + 2 * st, dt),
        "dt_proj": dense_init(gen, dtr, d_in, dt, bias=True),
        "A_log": torch.log(A.expand(d_in, st).clone()),     # (d_in, st) f32
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, d, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,d_in), w (cw,d_in).
    state (B,cw-1,d_in) holds the trailing inputs of the previous segment."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(cw):                  # the reference's sum, in its order
        y = y + xp[:, i:i + S] * w[i]
    return y + b


def _mamba_in(p, x: torch.Tensor, group):
    """in_proj's xi, z (B,S,d_in), each the rank's d_in / n channels under
    a process ``group`` (x entering through ``runtime.pvary``: the rank's
    in_proj block gives partial cotangents)."""
    if group is not None:
        x = runtime.pvary(x, group)
    return dense(p["in_proj"], x).chunk(2, dim=-1)


def _mamba_dbc(p, xc: torch.Tensor, dtr: int, st: int, group):
    """x_proj's dt_r, Bm, Cm from xc (B,S,d_in): under a process ``group``
    the rank's rows of x_proj summed over it (one ``all_reduce`` of (B S,
    dtr + 2 st), ``row_dense``), then through ``runtime.pvary`` into the
    rank's scan, whose cotangents are the rank's channels' share."""
    dbc = row_dense(p["x_proj"], xc, group)
    if group is not None:
        dbc = runtime.pvary(dbc, group)
    return torch.split(dbc, [dtr, st, st], dim=-1)


def _mamba_inner(p, xi: torch.Tensor, z: torch.Tensor, cfg: ArchConfig,
                 chunk: int, group=None):
    """conv, projections, scan, D skip and gate of ``mamba_apply`` and
    ``mamba_prefill``: xi, z (B,S,d_in) -> (y (B,S,d) , h_last).  Under a
    process ``group`` xi and z are the rank's channels, as are the conv,
    ``dt_proj``, ``A_log``, ``D`` and the scan (no collective inside
    it); ``x_proj`` and ``out_proj`` contract them, each summed with one
    ``all_reduce``.

    dt_proj's bias, the softplus, the scan from a zero state, the D skip
    and the silu(z) gate are one call of ``kernels.selective_scan_fused``:
    one kernel launch on the card, z read in place as the second half of
    in_proj's output (with a gradient asked, one forward launch and one
    of the backward kernel); on the CPU the plain version, chunk by chunk
    as the reference's ``lax.scan`` carries the state (its zero padding of
    the last chunk leaves the state as it is: ``exp(0 * A) = 1`` and ``0 *
    x = 0``, so no padding is needed)."""
    _, dtr, st, _ = _mamba_dims(cfg)
    xc = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt_r, Bm, Cm = _mamba_dbc(p, xc, dtr, st, group)
    dt_proj = p["dt_proj"]
    A = -torch.exp(p["A_log"])                                # (d_in, st)
    h_last, y = scan_kernels.selective_scan_fused(
        None, dt_r @ dt_proj["w"], Bm, Cm, A, xc, p["D"], z, dt_proj["b"],
        chunk)
    return row_dense(p["out_proj"], y, group), h_last


def mamba_apply(p, x: torch.Tensor, cfg: ArchConfig, *,
                chunk: int = 256) -> torch.Tensor:
    """Train/prefill. x (B,S,d) -> (B,S,d)."""
    group = runtime.tp_group(cfg)
    xi, z = _mamba_in(p, x, group)                            # (B,S,d_in)
    return _mamba_inner(p, xi, z, cfg, chunk, group)[0]


def mamba_prefill(p, x: torch.Tensor, cfg: ArchConfig):
    """Returns (y, h_state (B,d_in,st) f32, conv_state (B,cw-1,d_in)),
    the rank's d_in / n channels of the states under a process group."""
    S = x.shape[1]
    _, _, _, cw = _mamba_dims(cfg)
    group = runtime.tp_group(cfg)
    xi, z = _mamba_in(p, x, group)
    if S >= cw - 1:
        # a copy: a view would keep the layer's whole (B, S, 2 d_in)
        # in_proj output alive in the cache
        conv_state = xi[:, S - (cw - 1):, :].clone()
    else:
        conv_state = F.pad(xi, (0, 0, cw - 1 - S, 0))
    y, h_last = _mamba_inner(p, xi, z, cfg, 256, group)
    return y, h_last, conv_state


def mamba_decode(p, x: torch.Tensor, h: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ArchConfig):
    """Single step. x (B,1,d); h (B,d_in,st) f32; conv_state (B,cw-1,d_in)
    (the rank's d_in / n channels under a process group, as in
    :func:`_mamba_inner`).  Returns (y (B,1,d), h, conv_state), plain
    PyTorch as the reference's."""
    _, dtr, st, _ = _mamba_dims(cfg)
    group = runtime.tp_group(cfg)
    xi, z = _mamba_in(p, x, group)                            # (B,1,d_in)
    window = torch.cat([conv_state.to(x.dtype), xi], dim=1)   # (B,cw,d_in)
    xc = F.silu(torch.einsum("bcd,cd->bd", window, p["conv_w"])
                + p["conv_b"])
    conv_state = window[:, 1:]
    dt_r, Bm, Cm = _mamba_dbc(p, xc, dtr, st, group)
    dt = F.softplus(dense(p["dt_proj"], dt_r).float())        # (B,d_in)
    A = -torch.exp(p["A_log"])
    Abar = torch.exp(dt[..., None] * A)                       # (B,d_in,st)
    Bx = (dt * xc.float())[..., None] * Bm.float()[:, None, :]
    h = Abar * h + Bx
    y = torch.einsum("bds,bs->bd", h, Cm.float())
    y = y + p["D"] * xc.float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    return row_dense(p["out_proj"], y, group)[:, None, :], h, conv_state


# ===================================================================== #
# RG-LRU (RecurrentGemma) recurrent block
# ===================================================================== #
_LRU_C = 8.0


def rglru_init(gen: Gen, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    w = cfg.hybrid.lru_width or d
    cw = cfg.hybrid.conv_width
    dt = cfg.jdtype
    dev = init_device(gen)
    return {
        "in_x": dense_init(gen, d, w, dt),
        "in_gate": dense_init(gen, d, w, dt),
        "conv_w": normal(gen, (cw, w), 1.0 / math.sqrt(cw), dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "wa": dense_init(gen, w, w, dt, bias=True),          # recurrence gate
        "wx": dense_init(gen, w, w, dt, bias=True),          # input gate
        "lam": torch.full((w,), 4.0, dtype=torch.float32, device=dev),
        "out": dense_init(gen, w, d, dt),
    }


def _rglru_gates(p, xc: torch.Tensor, group=None):
    """(a, gated) of the recurrence h_t = a_t h_{t-1} + gated_t, fp32:
    ``a = exp(-8 softplus(lam) r)`` and ``gated = sqrt(max(1 - a^2,
    1e-12)) * i * xc``, r and i the sigmoid gates.  Under a process
    ``group`` xc is the rank's w / n channels: the gate matmuls (``wa``,
    ``wx`` cut by output) read every channel, all-gathered once
    (``runtime.gather_last_summed``: each rank's gates give a partial
    cotangent of the whole xc), and give the rank's channels of r and i;
    the gated term multiplies the rank's own xc."""
    xa = xc if group is None else runtime.gather_last_summed(xc, group)
    r = torch.sigmoid(dense(p["wa"], xa).float())
    i = torch.sigmoid(dense(p["wx"], xa).float())
    log_a = -_LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xc.float())
    return a, gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of the pairs (a_t, b_t) along dim 1 under
    ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``: log2(S) doubling
    steps, no loop over time.  Returns (prod a, h from a zero state)."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _rglru_scan(p, xc: torch.Tensor, h0: torch.Tensor, *, chunk: int = 256,
                group=None):
    """xc (B,S,w) post-conv branch; h0 (B,w) fp32 (the rank's w / n
    channels of both under a process ``group``: only the gates read
    across ranks, :func:`_rglru_gates`).  Returns (y (B,S,w)
    fp32, h_last (B,w)): the reference's scan, as plain PyTorch that
    autograd differentiates.  Every ``chunk``-step chunk is scanned from a
    zero state at once (log2(chunk) doubling steps over all chunks), then
    a loop over the chunks carries h into each chunk's start, as the
    reference's ``lax.scan`` does.  ``h_last`` is the state after the last
    real step (the reference's zero padding of a ragged last chunk past
    one chunk gives it the state at the padding's end, 0)."""
    a, gated = _rglru_gates(p, xc, group)
    B, S, w = a.shape
    c = min(chunk, S)
    n = -(-S // c)
    if n * c > S:                  # the tail is sliced off below
        a = F.pad(a, (0, 0, 0, n * c - S))
        gated = F.pad(gated, (0, 0, 0, n * c - S))
    a_sc, b_sc = (t.reshape(B, n, c, w) for t in _linear_scan(
        a.reshape(B * n, c, w), gated.reshape(B * n, c, w)))
    h, starts = h0, []
    for i in range(n):
        starts.append(h)
        h = b_sc[:, i, -1] + a_sc[:, i, -1] * h
    hc = b_sc + a_sc * torch.stack(starts, dim=1)[:, :, None]
    y = hc.reshape(B, n * c, w)[:, :S]
    return y, y[:, -1]


def rglru_apply(p, x: torch.Tensor, cfg: ArchConfig,
                h0: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full recurrent block: (gate branch) * RG-LRU(conv(x branch)) -> out.
    With ``return_state`` also (h_last (B,w) fp32, conv tail (B,cw-1,w)).
    Under a process group (``runtime.tp_group``) ``in_x`` / ``in_gate``
    give the rank's w / n channels (x entering through ``runtime.pvary``),
    the conv, the recurrence and its states are the rank's, and ``out``
    contracts them with one ``all_reduce`` (``row_dense``)."""
    B, S, _ = x.shape
    cw = cfg.hybrid.conv_width
    group = runtime.tp_group(cfg)
    if group is not None:
        x = runtime.pvary(x, group)
    xb = dense(p["in_x"], x)
    gate = F.gelu(dense(p["in_gate"], x), approximate="tanh")
    if S >= cw - 1:
        new_conv = xb[:, S - (cw - 1):, :].clone()
    else:
        new_conv = F.pad(xb, (0, 0, cw - 1 - S, 0))
    xc = _causal_conv(xb, p["conv_w"], p["conv_b"], state=conv_state)
    if h0 is None:
        h0 = torch.zeros((B, xb.shape[-1]), dtype=torch.float32,
                         device=x.device)
    y, h_last = _rglru_scan(p, xc, h0, group=group)
    out = row_dense(p["out"], y.to(x.dtype) * gate, group)
    if return_state:
        return out, h_last, new_conv
    return out


def rglru_decode(p, x: torch.Tensor, h: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ArchConfig):
    """x (B,1,d); h (B,w) fp32; conv_state (B,cw-1,w) (the rank's w / n
    channels under a process group, as in :func:`rglru_apply`).  Returns
    (out (B,1,d), h, conv_state), plain PyTorch as the reference's."""
    group = runtime.tp_group(cfg)
    if group is not None:
        x = runtime.pvary(x, group)
    xb = dense(p["in_x"], x)                                   # (B,1,w)
    gate = F.gelu(dense(p["in_gate"], x), approximate="tanh")
    window = torch.cat([conv_state.to(x.dtype), xb], dim=1)
    xc = torch.einsum("bcw,cw->bw", window, p["conv_w"]) + p["conv_b"]
    conv_state = window[:, 1:]
    a, gated = _rglru_gates(p, xc, group)
    h = a * h + gated
    out = row_dense(p["out"], h[:, None].to(x.dtype) * gate, group)
    return out, h, conv_state
