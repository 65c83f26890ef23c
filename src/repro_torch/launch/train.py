"""Training launcher, KGE mode (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.train --workload go \\
        --registry /tmp/biokg --models transe,distmult
    PYTHONPATH=src python -m repro_torch.launch.train --workload go \\
        --registry /tmp/biokg --models transe,distmult --device cpu \\
        --n-terms 400 --steps 200

Generates the synthetic GO/HP release, trains the chosen KGE models on one
device (``--device``, default ``cuda``; paper defaults: dim=200,
epochs=100 — cap with ``--steps``, shrink with ``--n-terms``), and
publishes versioned snapshots with PROV metadata through the port's
``Updater``.  A registry that already holds a parent version gets an
incremental update.

The port trains TransE and DistMult so far.  The workloads list the
paper's six models, so ``--models`` must name the ones to train; without
it the launcher stops before any training and names the models still to
port.  The LM-zoo mode of ``repro.launch.train`` is not ported yet.
"""
from __future__ import annotations

import argparse
import importlib
from typing import Optional, Sequence

from ..core.registry import EmbeddingRegistry
from ..core.updater import SyntheticReleaseChannel, Updater, unported_models
from ..device import resolve_device
from ..ontology.synthetic import generate


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["go", "hp"], required=True)
    ap.add_argument("--registry", required=True)
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of the workload's models")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--n-terms", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--version", default="2023-01-01")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Train and publish; returns the ``UpdateReport``."""
    args = _parser().parse_args(argv)
    wl_mod = importlib.import_module(f"..configs.{args.workload}_kge",
                                     __package__)
    wl = wl_mod.CONFIG if args.n_terms is None else wl_mod.REDUCED
    if args.models is None:
        missing = unported_models(wl.models)
        if missing:
            raise SystemExit(
                f"[train] the {args.workload} workload trains {list(wl.models)}"
                f"; the PyTorch port cannot train {missing} yet: pass "
                f"--models with a subset, e.g. --models transe,distmult")
        models = tuple(wl.models)
    else:
        models = tuple(m for m in args.models.split(",") if m)
        extra = [m for m in models if m not in wl.models]
        if extra or not models:
            raise SystemExit(f"[train] --models {args.models!r}: the "
                             f"{args.workload} workload has {list(wl.models)}")
    device = resolve_device(args.device)
    n = args.n_terms or wl.n_terms

    print(f"[train] generating synthetic {args.workload.upper()} ({n} terms)")
    kg = generate(wl.spec, seed=args.seed, n_terms=n)
    print(f"[train] {kg.num_entities} entities, {len(kg.triples)} triples, "
          f"{kg.num_relations} relations")

    registry = EmbeddingRegistry(args.registry)
    updater = Updater(registry, models=models, dim=wl.dim,
                      train_cfg=wl.train, steps_override=args.steps,
                      device=device)
    channel = SyntheticReleaseChannel(args.workload, args.version, kg)
    rep = updater.run_once(channel, seed=args.seed)
    print(f"[train] {rep.mode} update: published {rep.trained_models} "
          f"v{rep.version} on {device} in {rep.wall_s:.1f}s ({rep.reason})")
    for m, d in rep.details.items():
        print(f"  {m:10s} {d['steps']} steps loss={d['final_loss']:.4f} "
              f"{d['triples_per_s']:.0f} triples/s")
    return rep


if __name__ == "__main__":
    main()
