"""Shared LM scaffolding: the port of ``repro.models.lm`` (serving part).

Every model exposes the JAX package's surface, with the params held in the
model (``model.params``, a :class:`~repro_torch.models.layers.ParamTree`
keyed as the reference's param pytree) instead of passed in:

    model.init(generator)                 -> model (params drawn on the
                                             generator's device)
    model.prefill(batch, cache_len)       -> (last_logits, cache)
    model.decode_step(cache, token, pos)  -> (logits, cache)
    model.cache_spec(batch, seq)          -> meta tensors (shapes, dtypes)

``models/convert.py`` fills ``model.params`` from the JAX package's params
instead.  The reference's ``jax.lax.scan`` over stacked layers is a loop
over ``params["layers"]``, an ``nn.ModuleList``.  ``loss`` and ``xent``
(training) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..kernels.ref import no_tf32
from .config import ArchConfig
from .layers import Gen, ParamTree, apply_norm, norm_init, normal


class BaseLM(nn.Module):
    """Decoder-only scaffold shared by the zoo's families."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.params: Optional[ParamTree] = None

    # ---------------- params ---------------- #
    def init_layers(self, gen: Gen) -> list:
        raise NotImplementedError

    def param_tree(self, gen: Gen) -> dict:
        """A fresh param dict, keyed as the reference's ``model.init``;
        ``gen=None`` gives meta tensors (shapes and dtypes only)."""
        cfg = self.cfg
        p = {
            "embed": normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                            cfg.jdtype),
            "layers": self.init_layers(gen),
            "ln_f": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = normal(gen, (cfg.d_model, cfg.padded_vocab), 0.02,
                                  cfg.jdtype)
        return p

    def init(self, gen: torch.Generator) -> "BaseLM":
        """Draw every param from ``gen``, on ``gen``'s device."""
        self.params = ParamTree(self.param_tree(gen))
        return self

    def _p(self) -> ParamTree:
        if self.params is None:
            raise RuntimeError(f"{self.cfg.arch_id}: no params; call "
                               f"init(generator) or convert.params_from_numpy")
        if self.params["embed"].is_cuda:
            no_tf32()
        return self.params

    # ---------------- forward pieces ---------------- #
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, d)."""
        return self._p()["embed"][tokens.long()]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        p = self._p()
        w = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        return h @ w

    # ---------------- family-specific hooks ---------------- #
    def backbone_prefill(self, x: torch.Tensor, cache_len: Optional[int] = None):
        """Returns (h, cache). ``cache_len`` pads attention caches with
        headroom for subsequent decode_step writes (serving allocates the
        max length up front)."""
        raise NotImplementedError

    def backbone_decode(self, cache, x: torch.Tensor, pos: int):
        """Returns (h (B,1,d), cache)."""
        raise NotImplementedError

    # ---------------- public API ---------------- #
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None):
        """``batch["tokens"]`` (B, S) -> (logits (B, 1, V) of the last
        position, cache)."""
        x = self.embed(batch["tokens"])
        h, cache = self.backbone_prefill(x, cache_len)
        h = apply_norm(self._p()["ln_f"], h[:, -1:])
        return self.logits(h), cache

    @torch.no_grad()
    def decode_step(self, cache, token: torch.Tensor, pos: int):
        """One token (B, 1) at position ``pos`` against ``cache``, which is
        updated in place -> (logits (B, 1, V), cache)."""
        x = self.embed(token)                            # (B,1,d)
        h, cache = self.backbone_decode(cache, x, int(pos))
        h = apply_norm(self._p()["ln_f"], h)
        return self.logits(h), cache

    def cache_spec(self, batch: int, seq: int):
        raise NotImplementedError

    def supports_long_context(self) -> bool:
        return False
