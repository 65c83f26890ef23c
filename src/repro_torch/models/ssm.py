"""Attention-free SSM LM — falcon-mamba-7b (mamba1 architecture): the port
of ``repro.models.ssm``.

Each layer: x + mamba(rmsnorm(x)).  No KV cache: the decode state is
``{"h": (L, B, d_inner, d_state) fp32, "conv": (L, B, cw-1, d_inner)}``,
constant in sequence length, which is why this arch runs long_500k.
Under a model axis of n (``runtime.tp_group``) a rank holds its
``d_inner / n`` channels of every layer and of its state
(``blocks.mamba_*``).  On
the card every prefill layer's selective scan is one launch of
``kernels/csrc/selective_scan.cu``, and every training step's too, with
its backward kernel (``launch.train --arch falcon-mamba-7b``);
``decode_step`` advances the state one step in plain PyTorch, as the
reference does, and writes it into the cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import blocks
from .layers import Gen, apply_norm, norm_init
from .lm import BaseLM, scan_layers


class MambaLM(BaseLM):
    def init_layers(self, gen: Gen) -> list:
        cfg = self.cfg
        return [{"ln": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
                 "mamba": blocks.mamba_init(gen, cfg)}
                for _ in range(cfg.n_layers)]

    def backbone(self, x: torch.Tensor):
        def body(p, h):
            return h + blocks.mamba_apply(p["mamba"], apply_norm(p["ln"], h),
                                          self.cfg)
        h = scan_layers(self._p()["layers"], x, body, self.cfg)
        return h, torch.zeros((), dtype=torch.float32, device=x.device)

    def backbone_prefill(self, x: torch.Tensor, cache_len: Optional[int] = None):
        """``cache_len`` is ignored: the state does not grow."""
        hs, cs = [], []
        h = x
        for p in self._p()["layers"]:
            y, hstate, cstate = blocks.mamba_prefill(
                p["mamba"], apply_norm(p["ln"], h), self.cfg)
            h = h + y
            hs.append(hstate)
            cs.append(cstate)
        return h, {"h": torch.stack(hs), "conv": torch.stack(cs)}

    def backbone_decode(self, cache, x: torch.Tensor, pos: int):
        hs, cs = cache["h"], cache["conv"]
        h = x
        for i, p in enumerate(self._p()["layers"]):
            y, hs[i], cs[i] = blocks.mamba_decode(
                p["mamba"], apply_norm(p["ln"], h), hs[i], cs[i], self.cfg)
            h = h + y
        return h, cache

    def cache_spec(self, batch: int, seq: int):
        """Under a process mesh (``runtime.use_mesh``) the rank's: its rows
        of ``batch`` (``cache_rows``) and its ``d_in / n`` channels
        (``local``)."""
        cfg = self.cfg
        d_in = self.local(cfg.ssm.expand * cfg.d_model)
        rows = self.cache_rows(batch)
        return {
            "h": torch.empty((cfg.n_layers, rows, d_in, cfg.ssm.d_state),
                             dtype=torch.float32, device="meta"),
            "conv": torch.empty((cfg.n_layers, rows, cfg.ssm.d_conv - 1,
                                 d_in), dtype=cfg.jdtype, device="meta"),
        }

    def supports_long_context(self) -> bool:
        return True
