"""Architecture configuration: the port's copy of
``repro.models.config``, with the same fields and values; ``jdtype`` is a
torch dtype here.

One ``ArchConfig`` fully describes a model in the zoo. Each ported
architecture gets a ``src/repro_torch/configs/<id>.py`` exporting ``CONFIG``
(the exact published dims) and ``REDUCED`` (a 2-layer, d_model<=512 variant of
the same family for CPU smoke tests).

Head sharding
-------------
The production mesh has a fixed ``model`` axis of 16, but published head
counts (56, 10, 8, ...) don't always divide it. We therefore distinguish:

* ``n_heads`` / ``n_kv_heads`` — the published numbers (the math of the model);
* ``kv_groups``              — the number of KV "slots" the runtime carries
  (= model-axis size in production, = ``n_kv_heads`` on CPU). KV heads are
  ``jnp.repeat``-ed to ``kv_groups`` (the standard vLLM/TPU replication
  trick for GQA with kv < tensor-parallel degree);
* ``padded_heads()``         — q-heads padded *per KV group* with zero-output
  heads so (a) the padded count divides ``kv_groups`` shards and (b) every
  shard's q-heads all map to the KV slot resident on that shard. Padding
  heads have zero out-projection rows, so the function computed is identical
  (see tests/test_models_padding.py and tests/test_torch_lm.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: repeating (recurrent, recurrent, local-attn)."""
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    lru_width: Optional[int] = None   # default d_model
    conv_width: int = 4
    window: int = 2048


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    qkv_bias: bool = False              # qwen2 uses bias on QKV
    attention: str = "full"             # full | sliding_window | none
    window: int = 4096                  # for sliding_window
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "swiglu"                 # swiglu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- VLM / audio frontend stubs -------------------------------------- #
    n_frontend_tokens: int = 0          # image-patch / audio-frame embeds
    dec_len_cap: int = 0                # enc-dec: max decoder length (whisper 448)
    # --- runtime ---------------------------------------------------------- #
    kv_groups: int = 0                  # 0 => n_kv_heads (no replication)
    moe_dp_blocks: int = 0              # MoE block-local dispatch blocks
                                        # (= data-axis size in production;
                                        # 0/1 = single global dispatch)
    moe_impl: str = "gspmd"             # gspmd | shard_map (explicit EP:
                                        # local dispatch to resident experts
                                        # + one token-shaped psum combine)
    moe_ff_split: int = 0               # split each expert's ff into r
                                        # virtual experts (E*r total) so
                                        # E*r divides the model axis =>
                                        # pure expert-parallelism, no ff-TP
                                        # psums (grok: 8e -> 16 virtual)
    seq_shard: bool = False             # sequence-shard the residual over
                                        # "model" between blocks (Megatron-SP
                                        # style; §Perf dense experiment)
    kv_cache_dtype: str = "model"       # model | int8 (quantized serving
                                        # cache: per-slot symmetric scales,
                                        # halves decode HBM traffic)
    dtype: str = "bfloat16"
    remat: str = "full"                 # full | none | dots
    source: str = ""                    # citation

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def groups(self) -> int:
        """KV slots carried at runtime."""
        return self.kv_groups or self.n_kv_heads

    def padded_heads(self) -> int:
        """q-heads padded per KV group so heads shard over ``groups``.

        g  = published q-heads per KV head
        m  = groups / gcd(groups, n_kv_heads)  (alignment quantum)
        g' = ceil(g / m) * m
        """
        if self.n_heads == 0:
            return 0
        g = self.n_heads // self.n_kv_heads
        m = self.groups // math.gcd(self.groups, self.n_kv_heads)
        gp = -(-g // m) * m
        return self.n_kv_heads * gp

    @property
    def heads_per_group(self) -> int:
        return self.padded_heads() // self.groups if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """vocab padded to a multiple of 256 so the logits shard cleanly."""
        return -(-self.vocab // 256) * 256

    @property
    def jdtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ #
    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.padded_vocab
        hp, g, hd = self.padded_heads(), self.groups, self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            dtr = s.dt_rank or -(-d // 16)
            per_layer = (d * 2 * d_in          # in_proj
                         + s.d_conv * d_in      # conv
                         + d_in * (dtr + 2 * s.d_state) + dtr * d_in  # x/dt proj
                         + d_in * s.d_state     # A_log
                         + d_in                 # D
                         + d_in * d)            # out_proj
            return emb + L * (per_layer + d) + d
        attn = d * hp * hd + 2 * d * self.n_kv_heads * hd + hp * hd * d
        if self.qkv_bias:
            attn += hp * hd + 2 * self.n_kv_heads * hd
        mlp_mult = 3 if self.act == "swiglu" else 2
        if self.moe:
            mlp = self.moe.n_experts * mlp_mult * d * ff + d * self.moe.n_experts
        else:
            mlp = mlp_mult * d * ff
        if self.family == "hybrid":
            h = self.hybrid
            w = h.lru_width or d
            rec = (2 * d * w + h.conv_width * w + 2 * w * w + 3 * w + w * d)
            n_attn = sum(1 for i in range(L)
                         if h.pattern[i % len(h.pattern)] == "attention")
            per_layer_sum = n_attn * (attn + mlp) + (L - n_attn) * (rec + mlp)
            return emb + per_layer_sum + L * 2 * d + d
        if self.family == "audio":
            # enc-dec: encoder layer (self-attn+mlp) + decoder layer
            # (self-attn + cross-attn + mlp); n_layers counts each stack.
            enc = attn + mlp
            dec = 2 * attn + mlp
            return emb + self.n_layers * (enc + dec) + 4 * self.n_layers * d + 2 * d
        return emb + L * (attn + mlp + 2 * d) + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        full = self.n_params()
        mlp_mult = 3 if self.act == "swiglu" else 2
        inactive = L * (self.moe.n_experts - self.moe.top_k) * mlp_mult * d * ff
        return full - inactive
