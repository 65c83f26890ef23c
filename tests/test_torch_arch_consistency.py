"""The port's counterparts of ``tests/test_arch_consistency.py`` and
``tests/test_models_padding.py``, for every arch the port has.

Per arch, at its reduced config in fp32: one smoke training step (finite
loss, params that move, the padded vocab), and the strongest correctness
check on the CPU:

  prefill(tokens[:, :S])            last-position logits
        == prefill(tokens[:, :S-1]) then decode_step(token S-1)

within the reference's ``TOL`` (2e-3): the KV cache write/read path, RoPE
at absolute positions, rolling SWA buffers, the Mamba conv/scan state
carry, whisper's decoder cache beside its cross-attention cache, and
llava's decode position after its image tokens.  The MoE archs run at
capacity factor 16, as the reference runs them.  Inputs are made by
numpy from a seed (the reference draws them with ``jax.random``).  Then
the zoo-wide contracts: constant-size decode state for falcon-mamba,
recurrentgemma and h2o-danube, the full-attention archs skipping long_500k, the published
dims and param counts, and head padding (llava's and whisper's).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.models import ARCH_IDS, build, get_config
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import ParamTree
from repro_torch.models.lm import cache_leaves
from repro_torch.models.steps import make_train_step

TOL = dict(rtol=2e-3, atol=2e-3)


def _f32(cfg):
    return cfg.with_(dtype="float32")


def _make_batch(model, cfg, B, S, seed=0):
    """``model.batch_spec``'s tensors: token ids for the int32 entries,
    N(0, 1) for the others."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.batch_spec(B, S).items():
        if v.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab, tuple(v.shape)).astype(np.int32)
        else:
            a = rng.standard_normal(tuple(v.shape), dtype=np.float32)
        out[k] = torch.from_numpy(a).to(v.dtype)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """Reduced variant: one forward + one optimizer step, finite loss,
    params actually change."""
    cfg = _f32(get_config(arch, reduced=True))
    model = build(cfg).init(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone()
              for n, p in model.params.named_parameters()}
    batch = _make_batch(model, cfg, B=2, S=32)
    step, optimizer = make_train_step(model, lr=1e-3)
    opt_state = optimizer.init(dict(model.params.named_parameters()))
    opt_state, metrics = step(opt_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    moved = any(not torch.equal(before[n], p)
                for n, p in model.params.named_parameters())
    assert moved
    # output embedding table shape is the padded vocab
    assert model.params["embed"].shape[0] == cfg.padded_vocab


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    cfg = _f32(get_config(arch, reduced=True))
    if cfg.moe is not None:
        # capacity dropping depends on which tokens share a prefill, so
        # the exact-equivalence claim needs no-drop capacity
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    model = build(cfg).init(torch.Generator().manual_seed(1))
    B = 2
    # long enough to wrap danube's and recurrentgemma's reduced SWA
    # windows (64)
    S = 80 if cfg.attention == "sliding_window" or cfg.family == "hybrid" \
        else 48
    if cfg.family == "audio":
        S = 256  # decoder length = S // 8 = 32 <= cap
    batch = _make_batch(model, cfg, B, S)
    batch.pop("labels")
    full_logits, _ = model.prefill(batch)

    # drop the last *text* token, prefill, then decode it
    toks = batch["tokens"]
    batch_m1 = dict(batch, tokens=toks[:, :-1])
    if cfg.family == "audio":
        pos = toks.shape[1] - 1
    elif cfg.family == "vlm":
        pos = batch["image_embeds"].shape[1] + toks.shape[1] - 1
    else:
        pos = S - 1
    _, cache = model.prefill(batch_m1, cache_len=pos + 1)
    dec_logits, _ = model.decode_step(cache, toks[:, -1:], pos)
    np.testing.assert_allclose(dec_logits.numpy(), full_logits.numpy(),
                               **TOL)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "recurrentgemma_2b",
                                  "falcon_mamba_7b"])
def test_long_context_decode_state_is_constant_size(arch):
    """The long_500k-capable archs must have O(1)-in-seq decode state."""
    model = build(get_config(arch, reduced=True))
    small = model.cache_spec(1, 1_000)
    big = model.cache_spec(1, 1_000_000)
    sizes = lambda t: sorted(int(np.prod(v.shape))
                             for v in cache_leaves(t))
    assert sizes(small) == sizes(big)
    assert model.supports_long_context()


@pytest.mark.parametrize("arch", ["qwen2_72b", "mistral_large_123b",
                                  "grok_1_314b", "llava_next_34b"])
def test_full_attention_archs_skip_long500k(arch):
    cfg = get_config(arch)
    assert not applicable(cfg, SHAPES["long_500k"])
    assert applicable(cfg, SHAPES["decode_32k"])


def test_published_dims_match_assignment():
    """The exact numbers from the assignment table, for the ported archs."""
    expect = {
        "llava_next_34b": (60, 7168, 56, 8, 20480, 64000),
        "falcon_mamba_7b": (64, 4096, 0, 1, 0, 65024),
        "h2o_danube_1_8b": (24, 2560, 32, 8, 6912, 32000),
        "mistral_large_123b": (88, 12288, 96, 8, 28672, 32768),
        "whisper_base": (6, 512, 8, 8, 2048, 51865),
        "olmoe_1b_7b": (16, 2048, 16, 16, 1024, 50304),
        "grok_1_314b": (64, 6144, 48, 8, 32768, 131072),
        "qwen2_72b": (80, 8192, 64, 8, 29568, 152064),
        "recurrentgemma_2b": (26, 2560, 10, 1, 7680, 256000),
        "internlm2_20b": (48, 6144, 48, 8, 16384, 92544),
    }
    assert set(expect) == set(ARCH_IDS)
    for arch, (L, d, H, kv, ff, V) in expect.items():
        cfg = get_config(arch)
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_ff, cfg.vocab)
        assert got == (L, d, H, kv, ff, V), (arch, got)
    assert get_config("olmoe_1b_7b").moe.n_experts == 64
    assert get_config("olmoe_1b_7b").moe.top_k == 8
    assert get_config("grok_1_314b").moe.n_experts == 8
    assert get_config("grok_1_314b").moe.top_k == 2
    assert get_config("falcon_mamba_7b").ssm.d_state == 16
    assert get_config("qwen2_72b").qkv_bias
    assert get_config("whisper_base").dec_len_cap == 448
    assert get_config("llava_next_34b").n_frontend_tokens == 2880
    assert get_config("recurrentgemma_2b").hybrid.pattern == (
        "recurrent", "recurrent", "attention")


def test_param_counts_are_plausible():
    """n_params() should land near the published sizes."""
    approx = {
        "falcon_mamba_7b": 7.3e9,
        "mistral_large_123b": 123e9,
        "qwen2_72b": 72e9,
        "grok_1_314b": 314e9,
        "internlm2_20b": 20e9,
        "olmoe_1b_7b": 7e9,
        "llava_next_34b": 34e9,
        "whisper_base": 74e6,
        "recurrentgemma_2b": 2.7e9,
    }
    for arch, target in approx.items():
        n = get_config(arch).n_params()
        assert 0.6 * target < n < 1.6 * target, (arch, n, target)
    a = get_config("olmoe_1b_7b").n_active_params()
    assert 0.8e9 < a < 2.0e9


# --------------- tests/test_models_padding.py, on the port -------------- #
def _mini_cfg(**kw):
    base = dict(arch_id="t", family="dense", n_layers=1, d_model=64,
                n_heads=6, n_kv_heads=2, d_ff=128, vocab=128,
                dtype="float32")
    base.update(kw)
    return ArchConfig(**base)


def test_padded_heads_math():
    # llava: 56 q heads, 8 kv, groups 16 -> pad groups of 7 to 8 => 64
    cfg = get_config("llava_next_34b").with_(kv_groups=16)
    assert cfg.padded_heads() == 64
    assert cfg.heads_per_group == 4
    # whisper: 8 q heads, 8 kv, groups 16 -> each group 1 -> 2 => 16
    cfg = get_config("whisper_base").with_(kv_groups=16)
    assert cfg.padded_heads() == 16
    # recurrentgemma: 10 q heads, 1 kv -> pad to 16
    cfg = get_config("recurrentgemma_2b").with_(kv_groups=16)
    assert cfg.padded_heads() == 16
    # qwen2: 64 q heads, 8 kv divide cleanly -> no padding
    cfg = get_config("qwen2_72b").with_(kv_groups=16)
    assert cfg.padded_heads() == 64
    # no-replication mode: identity
    for arch in ("qwen2_72b", "llava_next_34b", "whisper_base"):
        cfg = get_config(arch)
        assert cfg.padded_heads() == cfg.n_heads


def test_padded_forward_equals_unpadded():
    """kv_groups=8 on a (6 q-heads, 2 kv) model pads each group 3->4; copy
    the real-head weights into the padded layout and compare outputs."""
    ref_cfg = _mini_cfg()
    pad_cfg = _mini_cfg(kv_groups=8)
    assert pad_cfg.padded_heads() == 8
    p_ref = ParamTree(blocks.attn_init(torch.Generator().manual_seed(0),
                                       ref_cfg))
    hd, d = ref_cfg.hd, ref_cfg.d_model
    g, gp, kv = 3, 4, 2
    wq = p_ref["wq"]["w"].reshape(d, kv, g, hd)
    wq_pad = torch.zeros((d, kv, gp, hd))
    wq_pad[:, :, :g] = wq
    wo = p_ref["wo"]["w"].reshape(kv, g, hd, d)
    wo_pad = torch.zeros((kv, gp, hd, d))
    wo_pad[:, :g] = wo
    p_pad = ParamTree({
        "wq": {"w": wq_pad.reshape(d, kv * gp * hd)},
        "wk": {"w": p_ref["wk"]["w"].clone()},
        "wv": {"w": p_ref["wv"]["w"].clone()},
        "wo": {"w": wo_pad.reshape(kv * gp * hd, d)},
    })
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, d), dtype=np.float32))
    out_ref = blocks.attn_apply(p_ref, x, ref_cfg, causal=True)
    out_pad = blocks.attn_apply(p_pad, x, pad_cfg, causal=True)
    np.testing.assert_allclose(out_pad.numpy(), out_ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["llava_next_34b", "whisper_base"])
def test_padded_groups_leave_the_reduced_model_unchanged(arch):
    """The reduced arch with its q heads padded and its kv heads repeated
    (kv_groups 8) computes what the unpadded model computes, once the
    unpadded model's weights sit in the padded layout: prefill logits
    within 1e-5."""
    cfg = _f32(get_config(arch, reduced=True))
    pad = cfg.with_(kv_groups=8)
    model = build(cfg).init(torch.Generator().manual_seed(2))
    padded = build(pad).init(torch.Generator().manual_seed(3))
    g = cfg.n_heads // cfg.n_kv_heads
    gp = pad.padded_heads() // cfg.n_kv_heads
    hd, d, kv = cfg.hd, cfg.d_model, cfg.n_kv_heads
    src = dict(model.params.named_parameters())
    with torch.no_grad():
        for name, p in padded.params.named_parameters():
            w = src[name]
            if name.endswith(("attn.wq.w", "xattn.wq.w")):
                p.zero_()
                p.view(d, kv, gp, hd)[:, :, :g] = w.view(d, kv, g, hd)
            elif name.endswith(("attn.wo.w", "xattn.wo.w")):
                p.zero_()
                p.view(kv, gp, hd, d)[:, :g] = w.view(kv, g, hd, d)
            else:
                p.copy_(w)
    batch = _make_batch(model, cfg, 2, 256 if cfg.family == "audio" else 40)
    batch.pop("labels")
    want, _ = model.prefill(batch)
    got, _ = padded.prefill(batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_attn_init_zeroes_pad_heads():
    cfg = _mini_cfg(kv_groups=8)
    p = blocks.attn_init(torch.Generator().manual_seed(0), cfg)
    hd = cfg.hd
    wq = p["wq"]["w"].reshape(cfg.d_model, 2, 4, hd)
    wo = p["wo"]["w"].reshape(2, 4, hd, cfg.d_model)
    assert (wq[:, :, 3] == 0).all()            # pad slot per group
    assert (wo[:, 3] == 0).all()
    assert (wq[:, :, :3] != 0).any()
