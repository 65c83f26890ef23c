"""Greedy generation with the serving path: the port's counterpart of
``examples/generate_text.py``.

    PYTHONPATH=src python -m repro_torch.launch.generate --arch h2o-danube-1.8b
    PYTHONPATH=src python -m repro_torch.launch.generate --arch h2o-danube-1.8b \\
        --kv-cache-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.generate --arch olmoe-1b-7b \\
        --prompt-len 2048 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.generate --arch h2o-danube-1.8b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.generate \\
        --arch recurrentgemma-2b --prompt-len 4096 --steps 16
    PYTHONPATH=src python -m repro_torch.launch.generate \\
        --arch qwen2-72b --layers 32 --prompt-len 2048 --steps 16

Builds the arch (the published config unless ``--reduced``, cut to
``--layers`` layers if given; with ``--kv-cache-dtype int8`` the int8 KV
cache) with random params drawn from
``--seed`` on ``--device`` (default ``cuda``), prefills a seeded random
prompt with ``cache_len = prompt + steps``, then decodes ``--steps``
tokens greedily with ``make_serve_step``.  Prints the prefill time, the
decode time per token, the rates, the cache's bytes (an SSM's state,
and the hybrid's RG-LRU states, conv tails and rolling KV apart), the
peak device memory, for an MoE arch the (token, slot) pairs its
capacity dropped, and the continuation ids (the prefill's token, then
one per decode step), and checks that every id lies in ``[0,
padded_vocab)``.  On the card every
causal attention layer of the prefill (sliding-window, or full as a
window over every key) runs the SWA kernel once
(``kernels.swa_attention.launches``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import selective_scan, swa_attention
from ..models import build, get_config
from ..models.lm import cache_nbytes
from ..models.steps import make_prefill_step, make_serve_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's REDUCED config (default: CONFIG, the "
                         "published widths)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--frames", type=int, default=1500,
                    help="an audio arch's encoder frames (default 1500: "
                         "whisper's 30-s window after its conv stem, "
                         "arXiv:2212.04356)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's), for an arch whose weights outgrow "
                         "the card at full depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-cache-dtype", choices=("model", "int8"),
                    default="model",
                    help="the KV cache in the model's dtype (default) or "
                         "int8 with per-slot fp32 scales (dense archs)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    if min(args.batch, args.prompt_len, args.steps,
           1 if args.layers is None else args.layers) < 1:
        raise SystemExit("--batch, --prompt-len, --steps and --layers must "
                         "be >= 1")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced).with_(
        kv_cache_dtype=args.kv_cache_dtype)
    if args.layers is not None:
        cfg = cfg.with_(n_layers=args.layers)
    if cfg.kv_cache_dtype == "int8" and cfg.family != "dense":
        raise SystemExit(f"--kv-cache-dtype int8: {cfg.arch_id} is a "
                         f"{cfg.family} arch; the int8 KV cache is the dense "
                         f"family's (as in the reference)")
    if cfg.family == "audio" and args.prompt_len + args.steps > cfg.dec_len_cap:
        raise SystemExit(f"{cfg.arch_id}: --prompt-len {args.prompt_len} + "
                         f"--steps {args.steps} is past the decoder's cap of "
                         f"{cfg.dec_len_cap} tokens")
    model = build(cfg)
    print(f"[gen] {cfg.arch_id} ({cfg.n_params() / 1e6:.1f}M params, "
          f"{cfg.dtype}) on {dev}", flush=True)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    B, P = args.batch, args.prompt_len
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, P), dtype=np.int32)).to(dev)
    batch = {"tokens": prompt}
    pos0 = P                     # the first decode step's position
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, args.frames, cfg.d_model), dtype=np.float32)).to(
                dev, cfg.jdtype)
    elif cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)).to(
                dev, cfg.jdtype)
        pos0 += cfg.n_frontend_tokens
    prefill, serve = make_prefill_step(model), make_serve_step(model)

    moe = cfg.moe is not None
    swa_attention.reset_launches()
    selective_scan.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(batch, cache_len=pos0 + args.steps)
    tok = logits.argmax(-1).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = swa_attention.launches["swa_attention_forward"]
    scan_launches = sum(selective_scan.launches.values())
    prefill_dropped = model.take_dropped() if moe else None

    seq = [tok]
    t0 = time.perf_counter()
    for i in range(args.steps):
        tok, cache = serve(cache, tok, pos0 + i)
        seq.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    decode_dropped = model.take_dropped() if moe else None

    ids = torch.cat(seq, dim=1).cpu().numpy()
    if not ((ids >= 0) & (ids < cfg.padded_vocab)).all():
        raise RuntimeError(f"ids outside [0, {cfg.padded_vocab}): {ids}")
    cache_bytes = cache_nbytes(cache)
    out = {
        "arch": cfg.arch_id, "device": str(dev), "dtype": cfg.dtype,
        "layers": cfg.n_layers, "batch": B, "prompt_len": P,
        "steps": args.steps,
        "prefill_ms": prefill_s * 1e3,
        # the positions a prefill fills: a VLM's image tokens count; an
        # audio arch counts its decoder prompt (the frames are its input)
        "prefill_tok_per_s": B * pos0 / prefill_s,
        "decode_ms_per_token": decode_s * 1e3 / args.steps,
        "decode_tok_per_s": B * args.steps / decode_s,
        "swa_launches_prefill": prefill_launches,
        "scan_launches_prefill": scan_launches,
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "cache_bytes": cache_bytes,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "ids": ids.tolist(),
    }
    if cfg.family == "ssm":
        out["state_bytes"] = cache_bytes      # the cache is the SSM state
    elif cfg.family == "hybrid":
        # each layer's state: (h, conv) recurrent, (k, v) attention
        states = [(kind, st) for group in cache.values()
                  for kind, st in zip(model.pattern, group)]
        rec = [st for kind, st in states if kind == "recurrent"]
        out["lru_state_bytes"] = cache_nbytes([st[0] for st in rec])
        out["conv_state_bytes"] = cache_nbytes([st[1] for st in rec])
        out["kv_cache_bytes"] = cache_nbytes(
            [st for kind, st in states if kind == "attention"])
    elif cfg.family == "audio":
        out["frames"] = args.frames
    elif cfg.family == "vlm":
        out["image_tokens"] = cfg.n_frontend_tokens
    if moe:
        # (token, slot) pairs past an expert's capacity, over all layers
        out["dropped_prefill"] = prefill_dropped
        out["dropped_per_decode_step"] = decode_dropped / args.steps
    print(f"[gen] prefill({pos0} tokens x {B}) {out['prefill_ms']:.1f} ms "
          f"({out['prefill_tok_per_s']:.0f} tok/s)")
    print(f"[gen] {args.steps} decode steps: {out['decode_ms_per_token']:.2f} "
          f"ms/token ({out['decode_tok_per_s']:.1f} tok/s at batch {B}); "
          f"{cfg.kv_cache_dtype} cache {out['cache_bytes'] / 2**20:.1f} MiB")
    print(f"[gen] continuation ids (seq 0): {ids[0].tolist()}")
    print(json.dumps({k: v for k, v in out.items() if k != "ids"}), flush=True)
    return out


if __name__ == "__main__":
    main()
