"""Dense decoder-only LM (mistral-large, qwen2, internlm2, h2o-danube): the
port of ``repro.models.dense``.

h2o-danube uses sliding-window attention (cfg.attention ==
"sliding_window"), whose prefill and training step run the CUDA kernels
``kernels/csrc/swa_attention.cu`` in every layer.

Under a process mesh with ``cfg.seq_shard`` (the reference's
``_maybe_seq_shard``, Megatron-style sequence parallelism) ``backbone``
keeps the residual between blocks sequence-sharded over ``"model"``:
each model rank holds S / n_model rows.  Each block all-gathers its input
inside its checkpointed function and slices its output back, so what
remat saves for a block is the rank's rows.  The blocks compute
replicated over ``"model"``, so the all-gather's backward is a slice and
the slice's an all-gather (``runtime.gather_seq`` / ``slice_seq``), not
a reduce-scatter; loss and gradients equal those of ``seq_shard=False``.
As in the reference, only ``backbone`` (training) takes it.  With the
weights cut over ``"model"`` (``runtime.tp_group``) a block runs its
tensor-parallel products on the gathered sequence, the reference's
``P(dp, "model", None)`` constraint on the same axis.

The cache keeps the reference's stacked ``(L, B, G, Sc, hd)`` layout, so
caches compare across the packages.  ``decode_step`` writes the new slot
into it in place, where the JAX package re-emits the cache.  With
``kv_cache_dtype="int8"`` the cache is int8 with ``(L, B, G, Sc)`` fp32
scales beside it (``k_scale``, ``v_scale``): prefill quantizes the whole
cache, decode quantizes each new slot on write and dequantizes a layer's
rows for its attention.  On a model axis of n a layer's cache is the
rank's ``(B, G / n, Sc, hd)`` (``BaseLM.kv_slots``), as ``cache_spec``
gives it under the mesh; the int8 cache's scales ``(L, B, G / n, Sc)``
too: a scale is per (row, slot, position) over hd, so a rank quantizes
and dequantizes its own slots and no step crosses ranks beyond the
``wo`` all_reduce the layer already issues.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import blocks, runtime
from .layers import Gen, apply_norm, mlp
from .lm import BaseLM, scan_layers


class DenseLM(BaseLM):
    @property
    def window(self) -> Optional[int]:
        return self.cfg.window if self.cfg.attention == "sliding_window" else None

    @property
    def quantized_cache(self) -> bool:
        return self.cfg.kv_cache_dtype == "int8"

    def init_layers(self, gen: Gen) -> list:
        return [blocks.block_init(gen, self.cfg)
                for _ in range(self.cfg.n_layers)]

    def backbone(self, x: torch.Tensor):
        mesh = runtime.get_mesh()
        group = None
        if self.cfg.seq_shard and mesh is not None:
            group = mesh.group("model")
            if x.shape[1] % mesh.shape["model"]:
                raise ValueError(
                    f"seq_shard: S = {x.shape[1]} does not divide into "
                    f"{mesh.shape['model']} model ranks")
            x = runtime.slice_seq(x, group)

        def body(p, h):
            if group is not None:
                h = runtime.gather_seq(h, group)
            h = blocks.block_apply(p, h, self.cfg, window=self.window)
            return h if group is None else runtime.slice_seq(h, group)
        h = scan_layers(self._p()["layers"], x, body, self.cfg)
        if group is not None:
            h = runtime.gather_seq(h, group)
        return h, torch.zeros((), dtype=torch.float32, device=x.device)

    def backbone_prefill(self, x: torch.Tensor, cache_len: Optional[int] = None):
        cfg = self.cfg
        B, S, _ = x.shape
        quant = self.quantized_cache
        if self.window is not None:
            Sc = self.window
        else:
            Sc = max(S, cache_len or 0)
        shape = (cfg.n_layers, B, self.kv_slots(), Sc, cfg.hd)
        kcs = torch.zeros(shape, dtype=x.dtype, device=x.device)
        vcs = torch.zeros(shape, dtype=x.dtype, device=x.device)
        h = x
        for i, p in enumerate(self._p()["layers"]):
            h, kc, vc = blocks.block_prefill(p, h, cfg, window=self.window)
            kcs[i, :, :, :kc.shape[2]] = kc
            vcs[i, :, :, :vc.shape[2]] = vc
        if quant:
            kq, ks = blocks.quantize_kv(kcs)
            vq, vs = blocks.quantize_kv(vcs)
            return h, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        return h, {"k": kcs, "v": vcs}

    def backbone_decode(self, cache, x: torch.Tensor, pos: int):
        cfg = self.cfg
        names = (("k", "v", "k_scale", "v_scale") if self.quantized_cache
                 else ("k", "v"))
        caches = [cache[n] for n in names]
        h = x
        for i, p in enumerate(self._p()["layers"]):
            kc, vc, *scales = caches
            a, *caches = blocks.attn_decode_inplace(
                p["attn"], apply_norm(p["ln1"], h), kc, vc, i, pos, cfg,
                window=self.window, k_scale=scales[0] if scales else None,
                v_scale=scales[1] if scales else None)
            h = h + a
            h = h + mlp(p["mlp"], apply_norm(p["ln2"], h), cfg.act,
                        runtime.tp_group(cfg))
        return h, dict(zip(names, caches))

    def cache_spec(self, batch: int, seq: int):
        cfg = self.cfg
        Sc = min(seq, cfg.window) if self.window is not None else seq
        shp = (cfg.n_layers, self.cache_rows(batch), self.kv_slots(), Sc,
               cfg.hd)
        if self.quantized_cache:
            return {"k": torch.empty(shp, dtype=torch.int8, device="meta"),
                    "v": torch.empty(shp, dtype=torch.int8, device="meta"),
                    "k_scale": torch.empty(shp[:-1], dtype=torch.float32,
                                           device="meta"),
                    "v_scale": torch.empty(shp[:-1], dtype=torch.float32,
                                           device="meta")}
        return {"k": torch.empty(shp, dtype=cfg.jdtype, device="meta"),
                "v": torch.empty(shp, dtype=cfg.jdtype, device="meta")}

    def supports_long_context(self) -> bool:
        return self.cfg.attention == "sliding_window"
