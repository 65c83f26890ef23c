"""Hybrid recurrent/attention LM — recurrentgemma-2b (Griffin): the port of
``repro.models.hybrid``.

The layer pattern repeats (recurrent, recurrent, local attention); every
layer is a temporal-mixing residual followed by an MLP residual.  The
reference scans its full periods over stacked params and unrolls the
remainder (26 = 8 * 3 + 2 layers); the port keeps one entry a layer in
``params["layers"]`` (layer ``3 i + j`` is period i's ``l{j}``, layer 24
+ i the reference's ``rem{i}``: ``models.convert`` maps them) and loops.
Training remats each full period, as the reference wraps its period body,
and runs the remainder plain.

The attention layers are the dense family's blocks with
``window = cfg.hybrid.window``: prefill and training run the SWA kernel
(head dim 256) and fill a rolling window cache.  The decode state keeps
the reference's layout, stacked over the periods, all of it constant in
the sequence's length:

    {"periods": ((h (P,B,w) fp32, conv (P,B,cw-1,w)),   # l0, recurrent
                 (h, conv),                            # l1, recurrent
                 (k (P,B,G,Sc,hd), v)),                # l2, attention
     "rem": ((h (B,w), conv (B,cw-1,w)), (h, conv))}

``decode_step`` writes it in place.

Under a model axis of n (``runtime.tp_group``) the RG-LRU layers run on
the rank's ``w / n`` channels (``blocks.rglru_*``), the attention layers
on its heads and KV slots and the MLPs on its ff columns, as the dense
family's; every state above is the rank's share (``cache_spec``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import blocks, runtime
from .layers import Gen, apply_norm, mlp, mlp_init, norm_init
from .lm import BaseLM, maybe_remat


def _rec_layer_init(gen: Gen, cfg) -> dict:
    return {"ln1": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
            "rec": blocks.rglru_init(gen, cfg),
            "ln2": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.jdtype, cfg.act)}


class HybridLM(BaseLM):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.pattern = tuple(cfg.hybrid.pattern)
        self.period = len(self.pattern)                       # 3
        self.n_periods = cfg.n_layers // self.period
        self.rem = self.pattern[:cfg.n_layers % self.period]

    def kind(self, layer: int) -> str:
        return self.pattern[layer % self.period]

    def _slot(self, layer: int):
        """Where layer ``layer``'s state sits in the cache: ``("periods",
        j, i)`` for period i's ``l{j}``, ``("rem", r, None)`` past them."""
        i, j = divmod(layer, self.period)
        if i < self.n_periods:
            return "periods", j, i
        return "rem", j, None

    # ---------------- params ---------------- #
    def init_layers(self, gen: Gen) -> list:
        cfg = self.cfg
        return [_rec_layer_init(gen, cfg) if self.kind(i) == "recurrent"
                else blocks.block_init(gen, cfg)
                for i in range(cfg.n_layers)]

    # ---------------- train ---------------- #
    def _apply_layer(self, kind: str, p, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if kind == "recurrent":
            h = h + blocks.rglru_apply(p["rec"], apply_norm(p["ln1"], h), cfg)
            return h + mlp(p["mlp"], apply_norm(p["ln2"], h), cfg.act,
                           runtime.tp_group(cfg))
        return blocks.block_apply(p, h, cfg, window=cfg.hybrid.window)

    def _period(self, layers, h: torch.Tensor) -> torch.Tensor:
        for kind, p in zip(self.pattern, layers):
            h = self._apply_layer(kind, p, h)
        return h

    def backbone(self, x: torch.Tensor):
        layers = self._p()["layers"]
        body = maybe_remat(self._period, self.cfg)
        h = x
        P = self.period
        for i in range(self.n_periods):
            h = body(layers[P * i:P * (i + 1)], h)
        for j, kind in enumerate(self.rem):
            h = self._apply_layer(kind, layers[P * self.n_periods + j], h)
        return h, torch.zeros((), dtype=torch.float32, device=x.device)

    # ---------------- prefill ---------------- #
    def backbone_prefill(self, x: torch.Tensor, cache_len: Optional[int] = None):
        """``cache_len`` is ignored: no state grows past the window."""
        cfg = self.cfg
        states = []
        h = x
        for i, p in enumerate(self._p()["layers"]):
            if self.kind(i) == "recurrent":
                y, hs, cs = blocks.rglru_apply(
                    p["rec"], apply_norm(p["ln1"], h), cfg, return_state=True)
                h = h + y
                h = h + mlp(p["mlp"], apply_norm(p["ln2"], h), cfg.act,
                            runtime.tp_group(cfg))
                states.append((hs, cs))
            else:
                h, kc, vc = blocks.block_prefill(p, h, cfg,
                                                 window=cfg.hybrid.window)
                states.append((kc, vc))
        P, n = self.period, self.n_periods
        periods = tuple(
            tuple(torch.stack([states[P * i + j][m] for i in range(n)])
                  for m in range(2))
            for j in range(P))
        return h, {"periods": periods, "rem": tuple(states[P * n:])}

    # ---------------- decode ---------------- #
    def backbone_decode(self, cache, x: torch.Tensor, pos: int):
        cfg = self.cfg
        h = x
        for i, p in enumerate(self._p()["layers"]):
            group, j, at = self._slot(i)
            a, b = cache[group][j]
            if at is not None:
                a, b = a[at], b[at]             # views: written in place
            if self.kind(i) == "recurrent":
                y, hs, cs = blocks.rglru_decode(
                    p["rec"], apply_norm(p["ln1"], h), a, b, cfg)
                a.copy_(hs)
                b.copy_(cs)
                h = h + y
                h = h + mlp(p["mlp"], apply_norm(p["ln2"], h), cfg.act,
                            runtime.tp_group(cfg))
            else:
                h, _, _ = blocks.block_decode(p, h, a, b, pos, cfg,
                                              window=cfg.hybrid.window)
        return h, cache

    # ---------------- specs ---------------- #
    def cache_spec(self, batch: int, seq: int):
        """Under a process mesh (``runtime.use_mesh``) the rank's: its rows
        of ``batch`` (``cache_rows``), its ``w / n`` recurrent channels and
        its KV slots (``local``, ``kv_slots``)."""
        cfg = self.cfg
        w = self.local(cfg.hybrid.lru_width or cfg.d_model)
        cw = cfg.hybrid.conv_width
        Sc = min(seq, cfg.hybrid.window)
        batch = self.cache_rows(batch)

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def state(kind, lead):
            if kind == "recurrent":
                return (meta(lead + (batch, w), torch.float32),
                        meta(lead + (batch, cw - 1, w), cfg.jdtype))
            shp = lead + (batch, self.kv_slots(), Sc, cfg.hd)
            return meta(shp, cfg.jdtype), meta(shp, cfg.jdtype)

        return {"periods": tuple(state(k, (self.n_periods,))
                                 for k in self.pattern),
                "rem": tuple(state(k, ()) for k in self.rem)}

    def supports_long_context(self) -> bool:
        return True
