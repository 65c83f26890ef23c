"""Training launcher, KGE mode (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.train --workload go \\
        --registry /tmp/biokg
    PYTHONPATH=src python -m repro_torch.launch.train --workload go \\
        --registry /tmp/biokg --device cpu --n-terms 400 --steps 200

Generates the synthetic GO/HP release, trains the workload's six KGE
models (``--models`` picks a subset) on one device (``--device``, default
``cuda``; paper defaults: dim=200, epochs=100 — cap with ``--steps``,
shrink with ``--n-terms``), and publishes versioned snapshots with PROV
metadata through the port's ``Updater``.  A registry that already holds
a parent version gets an incremental update.

The LM-zoo mode of ``repro.launch.train`` is not ported yet.
"""
from __future__ import annotations

import argparse
import importlib
from typing import Optional, Sequence

from ..core.registry import EmbeddingRegistry
from ..core.updater import SyntheticReleaseChannel, UpdateReport, Updater
from ..device import DeviceLike, resolve_device
from ..ontology.synthetic import generate


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["go", "hp"], required=True)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of the workload's models "
                         "(default: all six)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--n-terms", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--version", default="2023-01-01")
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


def main(argv: Optional[Sequence[str]] = None) -> UpdateReport:
    """Train and publish; returns the ``UpdateReport``."""
    args = _parser().parse_args(argv)
    models = None if args.models is None else tuple(
        m for m in args.models.split(",") if m)
    return train_kge(args.workload, args.registry, steps=args.steps,
                     n_terms=args.n_terms, seed=args.seed,
                     device=args.device, models=models, version=args.version)


if __name__ == "__main__":
    main()
