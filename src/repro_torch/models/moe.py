"""Mixture-of-Experts decoder LM (olmoe-1b-7b, grok-1-314b): the port of
``repro.models.moe``.

Each layer is causal attention (on the SWA kernel, a window over every
key) and the capacity-dropped top-k MoE of ``blocks.moe_apply``.  The
cache keeps the reference's stacked ``(L, B, G, S, hd)`` layout (the
rank's ``G / n`` slots on a model axis of n, as the dense family's);
``decode_step`` writes the new slot into it in place.  At decode the
capacity is that of one token per sequence (olmoe at B = 2: C = 1), so a
second token routed to a full expert is dropped, as in the reference.

``dropped`` counts the (token, slot) pairs that prefill and decode drop,
on the device; ``take_dropped()`` reads it and starts again from 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import blocks
from .layers import Gen, apply_norm
from .lm import BaseLM, scan_layers


class MoELM(BaseLM):
    def __init__(self, cfg):
        super().__init__(cfg)
        #: dropped (token, slot) pairs of prefill and decode since the
        #: last take_dropped(), a 0-dim int64 tensor on the params' device
        self.dropped: Optional[torch.Tensor] = None

    def _drops(self, device) -> torch.Tensor:
        if self.dropped is None or self.dropped.device != device:
            self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        return self.dropped

    def take_dropped(self) -> int:
        """Dropped (token, slot) pairs since the last call (one host
        sync), then 0 again."""
        n = 0 if self.dropped is None else int(self.dropped)
        self.dropped = None
        return n

    def init_layers(self, gen: Gen) -> list:
        return [blocks.moe_block_init(gen, self.cfg)
                for _ in range(self.cfg.n_layers)]

    def backbone(self, x: torch.Tensor):
        def body(p, h):
            return blocks.moe_block_apply(p, h, self.cfg)
        h, aux = scan_layers(self._p()["layers"], x, body, self.cfg,
                             with_aux=True)
        return h, aux / self.cfg.n_layers

    def backbone_prefill(self, x: torch.Tensor, cache_len: Optional[int] = None):
        cfg = self.cfg
        B, S, _ = x.shape
        shape = (cfg.n_layers, B, self.kv_slots(), max(S, cache_len or 0),
                 cfg.hd)
        kcs = torch.zeros(shape, dtype=x.dtype, device=x.device)
        vcs = torch.zeros(shape, dtype=x.dtype, device=x.device)
        drops = self._drops(x.device)
        h = x
        for i, p in enumerate(self._p()["layers"]):
            h, kc, vc = blocks.moe_block_prefill(p, h, cfg, drops)
            kcs[i, :, :, :S] = kc
            vcs[i, :, :, :S] = vc
        return h, {"k": kcs, "v": vcs}

    def backbone_decode(self, cache, x: torch.Tensor, pos: int):
        cfg = self.cfg
        kc, vc = cache["k"], cache["v"]
        drops = self._drops(x.device)
        h = x
        for i, p in enumerate(self._p()["layers"]):
            a, kc, vc = blocks.attn_decode_inplace(
                p["attn"], apply_norm(p["ln1"], h), kc, vc, i, pos, cfg)
            h = h + a
            y, _ = blocks.moe_dispatch(p["moe"], apply_norm(p["ln2"], h),
                                       cfg, drops)
            h = h + y
        return h, {"k": kc, "v": vc}

    def cache_spec(self, batch: int, seq: int):
        cfg = self.cfg
        shp = (cfg.n_layers, self.cache_rows(batch), self.kv_slots(), seq,
               cfg.hd)
        return {"k": torch.empty(shp, dtype=cfg.jdtype, device="meta"),
                "v": torch.empty(shp, dtype=cfg.jdtype, device="meta")}
