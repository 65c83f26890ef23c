"""Encoder-decoder audio model — whisper-base backbone: the port of
``repro.models.encdec``.

The modality frontend (mel spectrogram + conv downsampler) is a stub, as
in the reference: ``batch["frames"]`` carries precomputed frame embeddings
(B, S_enc, d).  The transformer is real: a non-causal encoder (the plain
``chunked_attention``, as the reference runs jnp there), a causal decoder
with cross-attention, GELU MLPs, LayerNorm, sinusoidal encoder positions,
learned decoder positions, tied logits (``h @ embed.T``: whisper's
config ties them, and ``BaseLM.logits`` reads it).

The decoder's causal self-attention at prefill and in training runs the
SWA kernel with a window over every key (``blocks._causal_attention``);
the cross-attention is ``plain_attention``.  The decoder is capped at
``cfg.dec_len_cap`` (whisper: 448), and the self-attention cache is always
that long.  The caches keep the reference's stacked layout: ``k``, ``v``
(L, B, G, cap, hd) and the encoder memory's ``xk``, ``xv`` (L, B, G,
S_enc, hd); ``decode_step`` writes the new slot into ``k`` / ``v`` in
place.

Under a model axis of n (``runtime.tp_group``; ``sharding.param_pspec``'s
layout) the tied ``embed`` holds the rank's ``padded_vocab / n`` rows and
``dec_pos`` stays whole.  The decoder's embedding is a masked gather of
the rank's rows summed over the axis (``runtime.row_lookup``: one
``all_reduce``, each rank's backward reaching its own rows); the logits are the rank's vocab block,
all-gathered (``BaseLM.logits``).  The encoder and decoder blocks run the
rank's ``G / n`` KV slots and their q heads, the cross-attention too
(``wq`` / ``wk`` / ``wv`` cut by output, ``wo`` by input and summed by one
``all_reduce``), the MLPs the rank's ff columns; every cache holds the
rank's ``G / n`` slots.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import blocks, runtime
from .config import ArchConfig
from .layers import (Gen, apply_norm, dense, mlp, mlp_init, norm_init, normal,
                     row_dense)
from .attention import plain_attention
from .lm import BaseLM, scan_layers, xent


def sinusoid(S: int, d: int, dtype, device=None) -> torch.Tensor:
    """(S, d) positions: sin and cos concatenated (not interleaved)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _dec_len(seq: int, cap: int) -> int:
    return max(8, min(cap, seq // 8))


def _cross_kv(p, mem: torch.Tensor, cfg: ArchConfig):
    """k, v (B, G, Sk, hd) of the encoder memory (B, Sk, d); on a model
    axis of n the rank's G / n slots (``blocks.project_kv``)."""
    group = runtime.tp_group(cfg)
    if group is not None:
        mem = runtime.pvary(mem, group)
    k, v = blocks.project_kv(p, mem, cfg, group)
    return k.movedim(1, 2), v.movedim(1, 2)


def _cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """x (B, Sq, d) against the slots ``k``, ``v`` (B, G, Sk, hd): the
    rank's G / n of them and their q heads on a model axis of n, ``wo``
    summed over it."""
    B, Sq, _ = x.shape
    group = runtime.tp_group(cfg)
    if group is not None:
        x = runtime.pvary(x, group)
    q = dense(p["wq"], x).reshape(B, Sq, k.shape[1], cfg.heads_per_group,
                                  cfg.hd)
    o = plain_attention(q, k.movedim(2, 1), v.movedim(2, 1), causal=False)
    return row_dense(p["wo"], o.reshape(B, Sq, -1), group)


def cross_attn_apply(p, x: torch.Tensor, mem: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """q from x (B,Sq,d); k/v from encoder memory (B,Sk,d)."""
    k, v = _cross_kv(p, mem, cfg)
    return _cross_attend(p, x, k, v, cfg)


def _dec_layer_init(gen: Gen, cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "attn": blocks.attn_init(gen, cfg),
        "lnx": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "xattn": blocks.attn_init(gen, cfg),
        "ln2": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.jdtype, cfg.act),
    }


class EncDecModel(BaseLM):
    def param_tree(self, gen: Gen) -> dict:
        cfg = self.cfg
        return {
            "enc_layers": [blocks.block_init(gen, cfg)
                           for _ in range(cfg.n_layers)],
            "ln_e": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
            "embed": normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                            cfg.jdtype),
            "dec_pos": normal(gen, (cfg.dec_len_cap, cfg.d_model), 0.02,
                              cfg.jdtype),
            "dec_layers": [_dec_layer_init(gen, cfg)
                           for _ in range(cfg.n_layers)],
            "ln_f": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        }

    # ---------------- encoder ---------------- #
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        p = self._p()
        x = frames + sinusoid(frames.shape[1], cfg.d_model, frames.dtype,
                              frames.device)

        def body(lp, h):
            return blocks.block_apply(lp, h, cfg, causal=False)
        h = scan_layers(p["enc_layers"], x, body, cfg)
        return apply_norm(p["ln_e"], h)

    # ---------------- decoder ---------------- #
    def _dec_embed(self, tokens: torch.Tensor, pos0: int = 0) -> torch.Tensor:
        """(B, S) token ids at positions ``pos0``.. -> (B, S, d).  On a
        model axis of n ``embed`` holds the rank's ``padded_vocab / n``
        rows: a masked gather of them, summed over the axis."""
        p = self._p()
        S = tokens.shape[1]
        pos = p["dec_pos"][pos0:pos0 + S]
        group = runtime.tp_group(self.cfg)
        if group is None:
            return p["embed"][tokens.long()] + pos
        n = runtime.group_index(group)[0]
        rows = p["embed"].shape[0]
        if rows * n != self.cfg.padded_vocab:
            raise ValueError(f"embed holds {rows} rows, want "
                             f"{self.cfg.padded_vocab // n} on a model axis "
                             f"of {n} (convert.shard_params cuts them)")
        return runtime.row_lookup(p["embed"], tokens.long(), group) + pos

    def loss(self, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        x = self._dec_embed(batch["tokens"])
        mem = self.encode(batch["frames"])

        def body(p, h):
            h = h + blocks.attn_apply(p["attn"], apply_norm(p["ln1"], h),
                                      cfg, causal=True)
            h = h + cross_attn_apply(p["xattn"], apply_norm(p["lnx"], h),
                                     mem, cfg)
            return h + mlp(p["mlp"], apply_norm(p["ln2"], h), cfg.act,
                           runtime.tp_group(cfg))
        h = scan_layers(self._p()["dec_layers"], x, body, cfg)
        h = apply_norm(self._p()["ln_f"], h)
        mesh = runtime.get_mesh()
        loss, acc = xent(self.logits(h), batch["labels"],
                         None if mesh is None else runtime.data_group(mesh))
        return loss, {"ce": loss,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=h.device),
                      "acc": acc}

    # ---------------- serving ---------------- #
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None):
        """Encode frames, run the decoder prompt, build both caches (the
        self-attention cache is always ``dec_len_cap`` long; ``cache_len``
        is ignored)."""
        cfg = self.cfg
        p = self._p()
        L, G, hd, cap = cfg.n_layers, self.kv_slots(), cfg.hd, cfg.dec_len_cap
        if batch["tokens"].shape[1] > cap:
            raise ValueError(f"{cfg.arch_id}: a decoder prompt of "
                             f"{batch['tokens'].shape[1]} tokens is past "
                             f"dec_len_cap {cap}")
        x = self._dec_embed(batch["tokens"])
        mem = self.encode(batch["frames"])
        B, S, _ = x.shape
        Sk = mem.shape[1]
        kcs = x.new_zeros((L, B, G, cap, hd))
        vcs = x.new_zeros((L, B, G, cap, hd))
        xks = x.new_empty((L, B, G, Sk, hd))
        xvs = x.new_empty((L, B, G, Sk, hd))
        h = x
        for i, lp in enumerate(p["dec_layers"]):
            a, kc, vc = blocks.attn_prefill(lp["attn"],
                                            apply_norm(lp["ln1"], h), cfg)
            h = h + a
            xks[i], xvs[i] = _cross_kv(lp["xattn"], mem, cfg)
            h = h + _cross_attend(lp["xattn"], apply_norm(lp["lnx"], h),
                                  xks[i], xvs[i], cfg)
            h = h + mlp(lp["mlp"], apply_norm(lp["ln2"], h), cfg.act,
                        runtime.tp_group(cfg))
            kcs[i, :, :, :S] = kc
            vcs[i, :, :, :S] = vc
        h = apply_norm(p["ln_f"], h[:, -1:])
        return self.logits(h), {"k": kcs, "v": vcs, "xk": xks,
                                      "xv": xvs}

    @torch.no_grad()
    def decode_step(self, cache, token: torch.Tensor, pos: int):
        """One decoder token (B, 1) at position ``pos`` (< dec_len_cap)
        against ``cache``, whose ``k`` / ``v`` slot ``pos`` is written in
        place -> (logits (B, 1, V), cache)."""
        cfg = self.cfg
        p = self._p()
        pos = int(pos)
        if not 0 <= pos < cfg.dec_len_cap:
            raise ValueError(f"{cfg.arch_id}: decoder position {pos} outside "
                             f"[0, dec_len_cap {cfg.dec_len_cap})")
        x = self._dec_embed(token, pos0=pos)
        kc, vc, xks, xvs = cache["k"], cache["v"], cache["xk"], cache["xv"]
        h = x
        for i, lp in enumerate(p["dec_layers"]):
            a, kc, vc = blocks.attn_decode_inplace(
                lp["attn"], apply_norm(lp["ln1"], h), kc, vc, i, pos, cfg)
            h = h + a
            h = h + _cross_attend(lp["xattn"], apply_norm(lp["lnx"], h),
                                  xks[i], xvs[i], cfg)
            h = h + mlp(lp["mlp"], apply_norm(lp["ln2"], h), cfg.act,
                        runtime.tp_group(cfg))
        h = apply_norm(p["ln_f"], h)
        return self.logits(h), {"k": kc, "v": vc, "xk": xks,
                                      "xv": xvs}

    # ---------------- specs ---------------- #
    def batch_spec(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dl = _dec_len(seq, cfg.dec_len_cap)
        return {
            "frames": torch.empty((batch, seq, cfg.d_model), dtype=cfg.jdtype,
                                  device="meta"),
            "tokens": torch.empty((batch, dl), dtype=torch.int32,
                                  device="meta"),
            "labels": torch.empty((batch, dl), dtype=torch.int32,
                                  device="meta"),
        }

    def cache_spec(self, batch: int, seq: int):
        """The caches of ``batch`` rows against ``seq`` encoder frames; under
        a process mesh the rank's rows and KV slots."""
        cfg = self.cfg
        shape = (cfg.n_layers, self.cache_rows(batch), self.kv_slots())
        return {name: torch.empty(shape + (length, cfg.hd), dtype=cfg.jdtype,
                                  device="meta")
                for name, length in (("k", cfg.dec_len_cap),
                                     ("v", cfg.dec_len_cap),
                                     ("xk", seq), ("xv", seq))}
