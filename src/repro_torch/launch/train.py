"""Training launcher: the KGE mode (the paper's workload) and the LM mode.

    PYTHONPATH=src python -m repro_torch.launch.train --workload go \
        --registry /tmp/biokg
    PYTHONPATH=src python -m repro_torch.launch.train --workload go \
        --registry /tmp/biokg --device cpu --n-terms 400 --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --batch 1 --seq 6144 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        --batch 2 --seq 2048 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --batch 2 --seq 4096 --steps 5

KGE (``--workload``): generates the synthetic GO/HP release, trains the
workload's six KGE models (``--models`` picks a subset) on one device
(``--device``, default ``cuda``; paper defaults: dim=200, epochs=100 —
cap with ``--steps``, shrink with ``--n-terms``), and publishes versioned
snapshots with PROV metadata through the port's ``Updater``.  A registry
that already holds a parent version gets an incremental update.

LM (``--arch``): the arch's config (``--reduced`` for its small one)
with random params drawn from ``--seed``,
``--steps`` Adam steps (default 20, lr 3e-4) through
``models.steps.make_train_step`` on random batches drawn as
``repro.launch.train.train_lm`` draws them (numpy ``default_rng(seed)``,
each step, in the order of ``model.batch_spec``'s keys: token ids for
tokens and labels, N(0, 1) for whisper's frames and llava's image
embeddings).  Prints the reference's loss line every
``max(1, steps // 10)`` steps, then step ms, tokens/s and peak device
memory, and the kernels' launches of the run by entry point.  On the
card every sliding-window layer runs the SWA forward kernel (twice a step
under ``remat="full"``: once more in the recompute) and the three
backward kernels (recurrentgemma's attention layers at head dim 256);
every Mamba layer the fused selective scan (twice a step under
``remat="full"``) and its backward kernel.  recurrentgemma's RG-LRU scan
has no kernel: autograd differentiates its plain form.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import time
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..core.registry import EmbeddingRegistry
from ..core.updater import SyntheticReleaseChannel, UpdateReport, Updater
from ..device import DeviceLike, resolve_device
from ..kernels import selective_scan, swa_attention
from ..models import build, get_config
from ..models.convert import params_from_numpy
from ..models.steps import make_train_step
from ..ontology.synthetic import generate


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["go", "hp"], default=None,
                    help="KGE mode (exactly one of --workload and --arch)")
    ap.add_argument("--registry", default=None,
                    help="KGE mode: the registry to publish into")
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of the workload's models "
                         "(default: all six)")
    ap.add_argument("--steps", type=int, default=None,
                    help="KGE: cap on steps a model; LM: steps (default 20)")
    ap.add_argument("--n-terms", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--version", default="2023-01-01")
    ap.add_argument("--arch", default=None,
                    help="LM mode: an arch of the zoo, e.g. h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="LM: the arch's REDUCED config (default: CONFIG, "
                         "the published widths)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    return ap


def train_kge(workload: str, registry_dir: str, steps: Optional[int] = None,
              n_terms: Optional[int] = None, seed: int = 0,
              device: DeviceLike = None,
              models: Optional[Sequence[str]] = None,
              version: str = "2023-01-01") -> UpdateReport:
    """Generate the ``workload`` release, train ``models`` (default: the
    workload's six) on ``device`` and publish them; returns the report."""
    wl_mod = importlib.import_module(f"..configs.{workload}_kge",
                                     __package__)
    wl = wl_mod.CONFIG if n_terms is None else wl_mod.REDUCED
    models = tuple(wl.models if models is None else models)
    extra = [m for m in models if m not in wl.models]
    if extra or not models:
        raise SystemExit(f"[train] --models {','.join(models)!r}: the "
                         f"{workload} workload has {list(wl.models)}")
    device = resolve_device(device)
    n = n_terms or wl.n_terms

    print(f"[train] generating synthetic {workload.upper()} ({n} terms)")
    kg = generate(wl.spec, seed=seed, n_terms=n)
    print(f"[train] {kg.num_entities} entities, {len(kg.triples)} triples, "
          f"{kg.num_relations} relations")

    registry = EmbeddingRegistry(registry_dir)
    updater = Updater(registry, models=models, dim=wl.dim,
                      train_cfg=wl.train, steps_override=steps,
                      device=device)
    channel = SyntheticReleaseChannel(workload, version, kg)
    rep = updater.run_once(channel, seed=seed)
    print(f"[train] {rep.mode} update: published {rep.trained_models} "
          f"v{rep.version} on {device} in {rep.wall_s:.1f}s ({rep.reason})")
    for m, d in rep.details.items():
        print(f"  {m:10s} {d['steps']} steps loss={d['final_loss']:.4f} "
              f"{d['triples_per_s']:.0f} triples/s")
    return rep


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_lm(arch: str, reduced: bool = False, steps: int = 20,
             batch: int = 4, seq: int = 128, seed: int = 0,
             device: DeviceLike = None,
             params: Optional[Mapping] = None) -> dict:
    """``steps`` Adam steps of ``arch`` on random token ids; returns the
    losses, accuracies, step times, tokens/s, peak device memory and the
    SWA and fused-scan kernels' launches by entry point.  ``params`` (the JAX package's param tree as
    numpy arrays, carried by ``models.convert.params_from_numpy``) replaces
    the params drawn from ``seed``."""
    if steps < 1 or batch < 1 or seq < 1:
        raise SystemExit("--steps, --batch and --seq must be >= 1")
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    model = build(cfg)
    print(f"[train] {cfg.arch_id}: {cfg.n_params() / 1e6:.1f}M params "
          f"({cfg.n_active_params() / 1e6:.1f}M active, {cfg.dtype}, remat "
          f"{cfg.remat}) on {dev}", flush=True)
    if params is None:
        model.init(torch.Generator(device=dev).manual_seed(seed))
    else:
        params_from_numpy(model, params, dev)
    step, optimizer = make_train_step(model)
    opt_state = optimizer.init(dict(model.params.named_parameters()))

    rng = np.random.default_rng(seed)

    spec = model.batch_spec(batch, seq)

    def make_batch():
        # the reference's draws, in batch_spec's key order: token ids for
        # the int32 entries, N(0, 1) for the others (frames, image
        # embeddings) in the model's dtype
        out = {}
        for name, like in spec.items():
            if like.dtype == torch.int32:
                a = rng.integers(0, cfg.vocab, tuple(like.shape)).astype(
                    np.int32)
            else:
                a = rng.normal(size=tuple(like.shape))
            out[name] = torch.from_numpy(a).to(dev, like.dtype)
        return out

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    swa_attention.reset_launches()
    selective_scan.reset_launches()
    losses, accs, step_ms = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        b = make_batch()
        t_step = time.perf_counter()
        opt_state, metrics = step(opt_state, b)
        _sync(dev)
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["acc"]))
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"  step {i:4d} loss={losses[-1]:.4f} acc={accs[-1]:.3f}",
                  flush=True)
    dt = time.perf_counter() - t0
    out = {
        "arch": cfg.arch_id, "device": str(dev), "dtype": cfg.dtype,
        "remat": cfg.remat, "batch": batch, "seq": seq, "steps": steps,
        "losses": losses, "accs": accs, "step_ms": step_ms,
        "step_ms_median": statistics.median(step_ms),
        "tokens_per_s": steps * batch * seq / dt,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "swa_launches": dict(swa_attention.launches),
        "scan_launches": dict(selective_scan.launches),
    }
    print(f"[train] {steps} steps, {dt:.1f}s, {out['tokens_per_s']:.0f} "
          f"tok/s, step {out['step_ms_median']:.1f} ms (median)"
          + ("" if out["peak_mem_bytes"] is None else
             f", peak {out['peak_mem_bytes'] / 2**30:.2f} GiB"))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("losses", "accs", "step_ms")}), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Union[UpdateReport, dict]:
    """Train: the KGE mode returns the ``UpdateReport``, the LM mode
    :func:`train_lm`'s dict."""
    args = _parser().parse_args(argv)
    if (args.workload is None) == (args.arch is None):
        raise SystemExit("[train] pass exactly one of --workload go|hp and "
                         "--arch <id>")
    if args.arch is not None:
        return train_lm(args.arch, reduced=args.reduced,
                        steps=20 if args.steps is None else args.steps,
                        batch=args.batch, seq=args.seq, seed=args.seed,
                        device=args.device)
    if args.registry is None:
        raise SystemExit("[train] --workload needs --registry")
    models = None if args.models is None else tuple(
        m for m in args.models.split(",") if m)
    return train_kge(args.workload, args.registry, steps=args.steps,
                     n_terms=args.n_terms, seed=args.seed,
                     device=args.device, models=models, version=args.version)


if __name__ == "__main__":
    main()
