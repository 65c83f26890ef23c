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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import blocks
from .config import ArchConfig
from .layers import Gen, apply_norm, dense, mlp, mlp_init, norm_init, normal
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
    """k, v (B, G, Sk, hd) of the encoder memory (B, Sk, d)."""
    B, Sk, _ = mem.shape
    hd, kv, G = cfg.hd, cfg.n_kv_heads, cfg.groups
    k = dense(p["wk"], mem).reshape(B, Sk, kv, hd)
    v = dense(p["wv"], mem).reshape(B, Sk, kv, hd)
    if G != kv:
        k = k.repeat_interleave(G // kv, dim=2)
        v = v.repeat_interleave(G // kv, dim=2)
    return k.movedim(1, 2), v.movedim(1, 2)


def _cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    B, Sq, _ = x.shape
    hd, G = cfg.hd, cfg.groups
    hp = cfg.padded_heads()
    q = dense(p["wq"], x).reshape(B, Sq, G, hp // G, hd)
    o = plain_attention(q, k.movedim(2, 1), v.movedim(2, 1), causal=False)
    return dense(p["wo"], o.reshape(B, Sq, -1))


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
        p = self._p()
        S = tokens.shape[1]
        return p["embed"][tokens.long()] + p["dec_pos"][pos0:pos0 + S]

    def loss(self, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        mem = self.encode(batch["frames"])
        x = self._dec_embed(batch["tokens"])

        def body(p, h):
            h = h + blocks.attn_apply(p["attn"], apply_norm(p["ln1"], h),
                                      cfg, causal=True)
            h = h + cross_attn_apply(p["xattn"], apply_norm(p["lnx"], h),
                                     mem, cfg)
            return h + mlp(p["mlp"], apply_norm(p["ln2"], h), cfg.act)
        h = scan_layers(self._p()["dec_layers"], x, body, cfg)
        h = apply_norm(self._p()["ln_f"], h)
        loss, acc = xent(self.logits(h), batch["labels"])
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
        L, G, hd, cap = cfg.n_layers, cfg.groups, cfg.hd, cfg.dec_len_cap
        if batch["tokens"].shape[1] > cap:
            raise ValueError(f"{cfg.arch_id}: a decoder prompt of "
                             f"{batch['tokens'].shape[1]} tokens is past "
                             f"dec_len_cap {cap}")
        mem = self.encode(batch["frames"])
        x = self._dec_embed(batch["tokens"])
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
            h = h + mlp(lp["mlp"], apply_norm(lp["ln2"], h), cfg.act)
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
            h = h + mlp(lp["mlp"], apply_norm(lp["ln2"], h), cfg.act)
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
        cfg = self.cfg
        L, G, hd = cfg.n_layers, cfg.groups, cfg.hd
        dt = cfg.jdtype
        return {
            "k": torch.empty((L, batch, G, cfg.dec_len_cap, hd), dtype=dt,
                             device="meta"),
            "v": torch.empty((L, batch, G, cfg.dec_len_cap, hd), dtype=dt,
                             device="meta"),
            "xk": torch.empty((L, batch, G, seq, hd), dtype=dt,
                              device="meta"),
            "xv": torch.empty((L, batch, G, seq, hd), dtype=dt,
                              device="meta"),
        }
