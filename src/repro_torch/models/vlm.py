"""VLM — llava-next-34b language backbone with the anyres tiling stub: the
port of ``repro.models.vlm``.

The vision tower (SigLIP/CLIP ViT + projector) is a stub, as in the
reference: ``batch["image_embeds"]`` carries (B, S_img, d_model) projected
patch embeddings (anyres: base tile + 4 sub-tiles = 5 * 576 = 2880
tokens).  The language model consumes [image ; text] and the loss runs
over text positions only (``BaseLM.loss``: the labels' positions).
Prefill is ``DenseLM``'s: full causal attention over image and text on
the SWA kernel (a window over every key), tensor-parallel on a mesh like
the dense family's, the image embeddings replicated over its model axis;
decode starts at position ``S_img + P``.
"""
from __future__ import annotations

from typing import Dict

import torch

from .dense import DenseLM


class VLM(DenseLM):
    def embed_batch(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        txt = self.embed(batch["tokens"])
        img = batch["image_embeds"].to(txt.dtype)
        return torch.cat([img, txt], dim=1)

    def batch_spec(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        s_img = min(cfg.n_frontend_tokens, max(seq // 2, 1))
        s_txt = seq - s_img
        return {
            "tokens": torch.empty((batch, s_txt), dtype=torch.int32,
                                  device="meta"),
            "labels": torch.empty((batch, s_txt), dtype=torch.int32,
                                  device="meta"),
            "image_embeds": torch.empty((batch, s_img, cfg.d_model),
                                        dtype=cfg.jdtype, device="meta"),
        }
