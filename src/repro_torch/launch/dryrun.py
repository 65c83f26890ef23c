"""Dry run: the shapes and memory of every (arch x input shape x mesh) on
the production mesh, on the meta device (no memory, no card).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --kge go
    PYTHONPATH=src python -m repro_torch.launch.dryrun --kge go --optimizer sgd

The port of ``repro.launch.dryrun``, with its config overrides (16 KV
slots, 16 or 32 MoE dispatch blocks, expert-parallel MoE, grok's ff
split, no remat for training at ``d_model <= 2560``) and its skips
(``configs.shapes.applicable``).  For each tag it records the global and
per-device bytes of what the step takes, laid out by ``models.sharding``:

  * train: the params, Adam's count / mu / nu and the batch;
  * prefill: the params, the batch and the cache the prefill returns;
  * decode: the params, the cache, the token and the position;
  * ``--kge``: the KGE tables, their optimizer's state (Adam unless
    ``--optimizer`` names another) and the triples.

For every family the per-device bytes are those a rank holds on a
process mesh of the same sizes (``convert.shard_params`` cuts by the
same rules; mamba's fused ``in_proj`` holds its two halves' blocks, the
same bytes).

One JSON a tag goes to ``--out`` (default ``build/dryrun``).  Not
reproduced: the reference lowers and compiles each step for its mesh and
records XLA's ``cost_analysis``, ``memory_analysis``'s temp sizes, the
HLO's collectives and the roofline terms built from them.  No compiler
for that mesh exists here, so the record leaves those fields out; it
does not estimate them.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..configs.shapes import SHAPES, applicable
from ..models import ARCH_IDS, build, get_config
from ..models.sharding import (batch_pspec, batch_shardings, cache_shardings,
                               device_bytes, param_pspec, param_shardings)
from ..models.steps import prefill_specs, serve_specs, train_specs
from .mesh import make_production_mesh

OUT = Path("build") / "dryrun"

#: the production runtime carries one KV slot a model-axis shard
PROD_KV_GROUPS = 16


def dryrun_config(arch: str, shape_name: str, multi_pod: bool):
    """The reference's production config for one tag."""
    cfg = get_config(arch).with_(kv_groups=PROD_KV_GROUPS,
                                 moe_dp_blocks=32 if multi_pod else 16,
                                 moe_impl="shard_map")
    if cfg.moe is not None and cfg.moe.n_experts % 16:
        # virtual ff split so the experts divide the model axis (grok: 8 -> 16)
        cfg = cfg.with_(moe_ff_split=16 // math.gcd(cfg.moe.n_experts, 16))
    if cfg.d_model <= 2560 and SHAPES[shape_name].step == "train":
        cfg = cfg.with_(remat="none")
    return cfg


def _flat_specs(cfg, mesh, flat):
    """Specs of a dict keyed by dotted param names (Adam's moments)."""
    size = mesh.shape["model"]
    return {n: param_pspec(cfg, tuple(n.split(".")), t.dim(), size)
            for n, t in flat.items()}


def _bytes(parts, mesh):
    """``{name: {"global": B, "per_device": B}}`` plus the totals, from
    ``{name: (tree, specs)}``."""
    out = {}
    for name, (tree, specs) in parts.items():
        g, d = device_bytes(tree, specs, mesh)
        out[name] = {"global": g, "per_device": d}
    out["total"] = {k: sum(v[k] for v in out.values())
                    for k in ("global", "per_device")}
    return out


def dryrun_one(arch: str, shape_name: str, multi_pod: bool) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    shape = SHAPES[shape_name]
    cfg = dryrun_config(arch, shape_name, multi_pod)
    if not applicable(cfg, shape):
        return {"tag": tag, "status": "skipped",
                "reason": "full-attention arch at 524k decode (quadratic)"}
    model = build(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    b, s = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    if shape.step == "train":
        params, opt, batch = train_specs(model, b, s)
        parts = {"params": (params, param_shardings(cfg, mesh, params)),
                 "opt_count": (opt.step, ()),
                 "opt_mu": (opt.mu, _flat_specs(cfg, mesh, opt.mu)),
                 "opt_nu": (opt.nu, _flat_specs(cfg, mesh, opt.nu)),
                 "batch": (batch, batch_shardings(mesh, b, batch))}
    elif shape.step == "prefill":
        params, batch = prefill_specs(model, b, s)
        cache = model.cache_spec(b, s)
        parts = {"params": (params, param_shardings(cfg, mesh, params)),
                 "batch": (batch, batch_shardings(mesh, b, batch)),
                 "cache": (cache, cache_shardings(cfg, mesh, b, cache))}
    else:
        params, cache, token, pos = serve_specs(model, b, s)
        parts = {"params": (params, param_shardings(cfg, mesh, params)),
                 "cache": (cache, cache_shardings(cfg, mesh, b, cache)),
                 "token": (token, batch_pspec(mesh, b, 2)),
                 "pos": (pos, ())}
    return {"tag": tag, "status": "ok", "arch": arch, "shape": shape_name,
            "mesh": mesh_name, "n_devices": mesh.size, "step": shape.step,
            "seq_len": s, "global_batch": b,
            "bytes": _bytes(parts, mesh),
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "seconds": time.perf_counter() - t0}


def dryrun_kge(workload: str, multi_pod: bool,
               optimizer: str = "adam") -> dict:
    """The paper's own workload: the sharded TransE training step's inputs
    over the full-size synthetic GO / HP (dim 200), batch 8,192, under
    ``optimizer`` (``optim.OPTIMIZERS``: its state's mu and nu counted as
    its ``init`` makes them, as the reference counts them)."""
    from ..kge import make_model
    from ..kge.train import TrainConfig
    from ..optim import OPTIMIZERS
    mesh_name = "multi" if multi_pod else "single"
    wl = importlib.import_module(f"repro_torch.configs.{workload}_kge").CONFIG
    model = make_model("transe", wl.n_terms, 3, dim=wl.dim)
    tc = TrainConfig(batch_size=8192, num_negs=32, optimizer=optimizer)
    mesh = make_production_mesh(multi_pod=multi_pod)
    params = {k: torch.empty(v, dtype=model.spec.dtype, device="meta")
              for k, v in model.param_shapes().items()}
    opt = OPTIMIZERS[tc.optimizer](tc.lr).init(params)
    p_sh = model.param_shardings("model", axis_size=mesh.shape["model"])
    dp = ("pod", "data") if multi_pod else ("data",)
    triples = torch.empty((tc.batch_size, 3), dtype=torch.int32,
                          device="meta")
    parts = {"params": (params, p_sh),
             "opt_count": (torch.empty((), dtype=torch.int32,
                                       device="meta"), ()),
             "opt_mu": (opt.mu, p_sh), "opt_nu": (opt.nu, p_sh),
             "triples": (triples, (dp, None))}
    tag = f"kge-{workload}__train__{mesh_name}"
    if optimizer != "adam":
        tag += f"__{optimizer}"
    return {"tag": tag, "status": "ok", "optimizer": optimizer,
            "workload": workload, "n_entities": wl.n_terms, "dim": wl.dim,
            "n_devices": mesh.size, "bytes": _bytes(parts, mesh)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kge", default=None, choices=["go", "hp"])
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "adagrad", "sgd"],
                    help="--kge's optimizer (default adam, TrainConfig's)")
    ap.add_argument("--out", default=str(OUT),
                    help="directory for one JSON a tag (default build/dryrun)")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.kge:
        jobs = [("kge", args.kge, None, mp) for mp in meshes]
    elif args.all:
        jobs = [("arch", a, s, mp) for a in ARCH_IDS for s in SHAPES
                for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all / --kge)")
        jobs = [("arch", args.arch, args.shape, mp) for mp in meshes]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = 0
    for kind, a, s, mp in jobs:
        t0 = time.perf_counter()
        try:
            rec = dryrun_kge(a, mp, args.optimizer) if kind == "kge" \
                else dryrun_one(a, s, mp)
        except Exception as e:        # one tag's fault must not hide the rest
            failures += 1
            print(f"[{time.perf_counter() - t0:7.2f}s] {a} {s} FAIL {e!r}",
                  flush=True)
            continue
        (out / f"{rec['tag']}.json").write_text(json.dumps(rec, indent=2))
        if rec["status"] == "ok":
            tot = rec["bytes"]["total"]
            print(f"[{time.perf_counter() - t0:7.2f}s] {rec['tag']:55s} OK "
                  f"per-device {tot['per_device'] / 2**30:.3f} GiB of "
                  f"{tot['global'] / 2**30:.3f}", flush=True)
        else:
            print(f"[{time.perf_counter() - t0:7.2f}s] {rec['tag']:55s} SKIP "
                  f"({rec['reason']})", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
