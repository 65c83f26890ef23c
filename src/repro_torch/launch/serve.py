"""Serving launcher — the paper's deployment mode, over the gateway API.

Stands up the Bio-KGvec2go gateway over a published registry on one
device (``--device``, default ``cuda``), then runs a concurrent request
session against the v1 endpoints and reports latency: ``--threads``
client threads call the typed gateway methods, which submit future-style
tickets that the BatchScheduler's background flush loop resolves under
its deadline policy (``--flush-after-ms`` or a full ``--batch``, whichever
first).  Top-k runs in the CUDA kernel on the card; with two or more
cards each table is row-sharded over all of them (``--no-shard``: one).

    PYTHONPATH=src python -m repro_torch.launch.serve --registry /tmp/biokg \\
        --requests 200 --batch 32 --threads 8 --flush-after-ms 2

With ``--http PORT`` the launcher instead serves the gateway over HTTP
in the foreground until interrupted; ``--workers N`` pre-forks N serving
processes (``api.workers.WorkerPool``) over the same mmap-resident store,
each on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --registry /tmp/biokg \\
        --http 8080 --workers 4
    curl 'localhost:8080/closest-concepts/go/transe?query=GO:0000001&k=5'

A registry with no published snapshot of ``--ontology`` is trained first
(``--train-if-missing``, on by default: the workload's six models, 150
steps, 800 terms), in a subprocess when workers will fork, so that no
CUDA context crosses the fork; with ``--no-train-if-missing`` an empty
registry is an error.  Either package's store serves as is.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..api import Gateway, serve_http
from ..api.schema import ClosestConceptsRequest
from ..core.registry import EmbeddingRegistry
from ..core.serving import ServingEngine
from ..device import resolve_device
from .mesh import make_serving_mesh


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--registry",
                    default=str(Path(tempfile.gettempdir()) / "biokgvec2go"),
                    help="snapshot store root (default: biokgvec2go under "
                         "the process's temporary directory)")
    ap.add_argument("--ontology", default="go")
    ap.add_argument("--model", default="transe")
    ap.add_argument("--device", default="cuda",
                    help="where top-k runs: cuda (the kernel) or cpu (its "
                         "plain PyTorch version)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--threads", type=int, default=8,
                    help="concurrent client threads")
    ap.add_argument("--flush-after-ms", type=float, default=2.0,
                    help="flush-loop deadline")
    ap.add_argument("--page", type=int, default=2000,
                    help="download page size (cursor pagination)")
    ap.add_argument("--no-shard", action="store_true",
                    help="serve every table from one device; by default "
                         "a table is row-sharded over every visible card "
                         "when there are two or more")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the gateway over HTTP on PORT (foreground; "
                         "0 = ephemeral) instead of running the client "
                         "session")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --http")
    ap.add_argument("--workers", type=int, default=1,
                    help="with --http: pre-fork this many worker "
                         "processes (SO_REUSEPORT) over the shared "
                         "mmap-resident snapshot store; 1 = classic "
                         "single-process serving")
    ap.add_argument("--state-dir", default=None,
                    help="with --workers > 1: where the workers dump their "
                         "state (default: a fresh temporary directory)")
    ap.add_argument("--train-if-missing", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="train and publish the workload's models first "
                         "when the registry has no --ontology snapshot "
                         "(on by default, as in the reference; with "
                         "--no-train-if-missing an empty registry is an "
                         "error)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="scheduler intake bound; past it submissions "
                         "fast-reject with OVERLOADED / HTTP 429 + "
                         "Retry-After instead of queueing without bound")
    ap.add_argument("--cache-entries", type=int, default=4096,
                    help="version-keyed result-cache entry bound "
                         "(0 disables the cache)")
    ap.add_argument("--cache-bytes", type=int, default=32 << 20,
                    help="result-cache wire-byte bound (0 disables)")
    ap.add_argument("--max-jobs-queued", type=int, default=8,
                    help="batch-job queue bound (per worker); past it "
                         "job submissions fast-reject with OVERLOADED / "
                         "HTTP 429 + Retry-After")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict[str, Any]]:
    """Run the launcher; in client-session mode returns the session's
    measurements (``qps``, ``p50_ms``, ``p99_ms`` of the concurrent
    top-k phase, ``sim_p50_ms``/``sim_p99_ms``, ``classes``)."""
    args = _parser().parse_args(argv)
    pool = args.http is not None and args.workers > 1
    # the pool's parent never resolves the device: that would create the
    # CUDA driver state its forked workers cannot use
    device = None if pool else resolve_device(args.device)
    registry = EmbeddingRegistry(args.registry)
    if not registry.versions(args.ontology):
        if not args.train_if_missing:
            raise SystemExit(
                f"[serve] no published {args.ontology!r} snapshots under "
                f"{args.registry} (--no-train-if-missing)")
        print(f"[serve] registry empty; training {args.ontology} snapshots")
        if pool:
            # train in a subprocess: training creates a CUDA context, and
            # a CUDA context must never cross the fork the worker pool is
            # about to do
            code = ("from repro_torch.launch.train import train_kge; "
                    f"train_kge({args.ontology!r}, {args.registry!r}, "
                    f"steps=150, n_terms=800, device={args.device!r})")
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in sys.path if p) + os.pathsep + env.get(
                    "PYTHONPATH", "")
            subprocess.run([sys.executable, "-c", code], env=env, check=True)
        else:
            from .train import train_kge
            train_kge(args.ontology, args.registry, steps=150, n_terms=800,
                      device=device)
    if pool:
        _serve_pool(args)
        return None

    mesh = None if args.no_shard else make_serving_mesh(kind=device.type)
    engine = ServingEngine(registry, device=device, mesh=mesh)
    gw = Gateway(engine, max_batch=args.batch,
                 flush_after_ms=args.flush_after_ms,
                 max_pending=args.max_pending,
                 result_cache_entries=args.cache_entries,
                 result_cache_bytes=args.cache_bytes,
                 max_jobs_queued=args.max_jobs_queued)

    if args.http is not None:
        server = serve_http(gw, host=args.host, port=args.http, start=False)
        base = server.url
        print(f"[serve] HTTP service on {base} ({device}) — the paper's "
              f"endpoints:")
        q = "GO:0000001"
        for line in (
                f"curl '{base}/health'",
                f"curl '{base}/get-vector/{args.ontology}/{args.model}"
                f"?query={q}'",
                f"curl '{base}/sim/{args.ontology}/{args.model}"
                f"?a={q}&b=GO:0000002'",
                f"curl '{base}/closest-concepts/{args.ontology}/{args.model}"
                f"?query={q}&k=5'",
                f"curl '{base}/download/{args.ontology}/{args.model}"
                f"?limit=3'   # ETag + If-None-Match -> 304",
                f"curl '{base}/download/{args.ontology}/{args.model}"
                f"?stream=true'   # chunked full table",
                f"curl '{base}/autocomplete/{args.ontology}/{args.model}"
                f"?prefix=term'",
                f"curl -X POST '{base}/jobs/submit' -d '{{\"kind\": "
                f"\"knn-join\", \"ontology\": \"{args.ontology}\", "
                f"\"model\": \"{args.model}\", \"classes\": [\"{q}\"], "
                f"\"k\": 5}}'   # -> {{job_id}}; poll /jobs/{{job_id}}",
                f"curl '{base}/jobs/JOB_ID/result?stream=true'"
                f"   # chunked rows once DONE",
                f"curl '{base}/stats'   # per-route latency histograms"):
            print(f"[serve]   {line}")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("\n[serve] shutting down")
        finally:
            server.server_close()
            gw.close()
        return None

    try:
        return _session(args, gw, device)
    finally:
        gw.close()


def _serve_pool(args) -> None:
    """``--http PORT --workers N``: the pre-forked pool in the foreground.
    This process only supervises; it never touches the card, and each
    worker resolves ``--device`` after the fork."""
    from ..api.workers import READY_TIMEOUT_S, WorkerPool
    pool = WorkerPool(args.registry, port=args.http, host=args.host,
                      workers=args.workers, device=args.device,
                      max_batch=args.batch,
                      flush_after_ms=args.flush_after_ms,
                      max_pending=args.max_pending,
                      result_cache_entries=args.cache_entries,
                      result_cache_bytes=args.cache_bytes,
                      max_jobs_queued=args.max_jobs_queued,
                      state_dir=args.state_dir)
    pool.start()
    try:
        pool.wait_ready(READY_TIMEOUT_S)
        base = pool.url
        print(f"[serve] HTTP service on {base} — {args.workers} workers on "
              f"{args.device} (pids {', '.join(map(str, pool.pids()))}; "
              f"{'SO_REUSEPORT' if pool.reuseport else 'inherited listener'}"
              f"; state {pool.state_dir})", flush=True)
        print(f"[serve]   curl '{base}/health'")
        print(f"[serve]   curl '{base}/closest-concepts/{args.ontology}/"
              f"{args.model}?query=GO:0000001&k=5'")
        print(f"[serve]   curl -X POST '{base}/jobs/submit' -d "
              f"'{{\"kind\": \"knn-join\", \"ontology\": \"{args.ontology}\", "
              f"\"model\": \"{args.model}\", "
              f"\"classes\": [\"GO:0000001\"], \"k\": 5}}'")
        print(f"[serve]   curl '{base}/stats'   # merged across workers",
              flush=True)
        stop = threading.Event()
        # SIGTERM stops the pool as Ctrl-C does (the workers ignore SIGINT)
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        try:
            while not stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            print("\n[serve] shutting down worker pool")
    finally:
        pool.stop()


def _session(args, gw: Gateway, device) -> Dict[str, Any]:
    mesh = gw.engine.mesh
    where = (f"sharded over {len(mesh.devices)} devices" if mesh
             else "single device")
    vers = gw.versions(args.ontology)
    total = gw.download(args.ontology, args.model, version=vers.latest,
                        limit=1).total
    print(f"[serve] {args.ontology}/{vers.latest}/{args.model}: "
          f"{total} classes, versions={vers.versions}, device={device}, "
          f"{where}")

    rng = np.random.default_rng(0)

    # -- endpoint: download (cursor-paginated); ids collected here so the
    # table is paged exactly once ---------------------------------------- #
    t0 = time.perf_counter()
    ids, nbytes, pages, offset = [], 0, 0, 0
    while offset is not None:
        page = gw.download(args.ontology, args.model, version=vers.latest,
                           offset=offset, limit=args.page)
        ids.extend(r[0] for r in page.rows)
        nbytes += sum(len(r[0]) + 8 * len(r[1]) for r in page.rows)
        offset = page.next_offset
        pages += 1
    print(f"[serve] download: {page.total} classes over {pages} pages "
          f"(~{nbytes/1e6:.1f} MB) in {time.perf_counter()-t0:.2f}s")

    # -- endpoint: sim (batch-first through the scheduler) -------------- #
    lat = []
    for _ in range(args.requests):
        a, b = (ids[i] for i in rng.integers(0, len(ids), 2))
        t0 = time.perf_counter()
        gw.similarity(args.ontology, args.model, a, b)
        lat.append(time.perf_counter() - t0)
    sim_ms = np.array(lat) * 1e3
    print(f"[serve] similarity: p50={np.percentile(sim_ms,50):.3f}ms "
          f"p99={np.percentile(sim_ms,99):.3f}ms over {args.requests} "
          f"requests")

    # -- endpoint: closest-concepts, concurrent clients + flush loop ---- #
    # warm every power-of-two padding bucket first (kernel build, pinned
    # staging, first launches), so the timed region measures serving
    b = 1
    while b <= args.batch:
        gw.closest_concepts_batch(
            [ClosestConceptsRequest(args.ontology, args.model,
                                    ids[i % len(ids)], args.k)
             for i in range(b)])
        b <<= 1
    warm_stats = dict(gw.scheduler.stats)   # report only the timed region

    queries = [ids[int(i)] for i in rng.integers(0, len(ids), args.requests)]
    chunks = [queries[i::args.threads] for i in range(args.threads)]
    lat, lat_lock = [], threading.Lock()
    sample = {}

    def client(cid, mine):
        out = []
        for q in mine:
            t1 = time.perf_counter()
            resp = gw.closest_concepts(args.ontology, args.model, q, k=args.k)
            out.append(time.perf_counter() - t1)
            if cid == 0 and not sample:
                sample[0] = resp
        with lat_lock:
            lat.extend(out)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client, args=(i, c))
               for i, c in enumerate(chunks)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    dt = time.perf_counter() - t0
    run_stats = {k: gw.scheduler.stats[k] - warm_stats[k] for k in warm_stats}
    lat_ms = np.array(lat) * 1e3
    summary = {
        "classes": int(total), "requests": int(args.requests),
        "threads": int(args.threads), "k": int(args.k),
        "seconds": dt, "qps": args.requests / dt,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "sim_p50_ms": float(np.percentile(sim_ms, 50)),
        "sim_p99_ms": float(np.percentile(sim_ms, 99)),
        "micro_batches": int(run_stats["batches"]),
        "padded_queries": int(run_stats["padded_queries"]),
    }
    print(f"[serve] top-{args.k}: {args.requests} requests from "
          f"{args.threads} clients in {dt:.2f}s "
          f"({summary['qps']:.0f} req/s; "
          f"{run_stats['batches']} micro-batches, "
          f"{run_stats['full_flushes']} full / "
          f"{run_stats['deadline_flushes']} deadline flushes, "
          f"{run_stats['padded_queries']} padded) "
          f"p50={summary['p50_ms']:.2f}ms p99={summary['p99_ms']:.2f}ms")

    # -- ops endpoints via the wire entry point ------------------------- #
    health = gw.handle("/health")
    stats = gw.handle("/stats")
    print(f"[serve] health={health['status']} "
          f"cache={stats['cache']} "
          f"gateway={{requests: {stats['gateway']['requests']}, "
          f"errors: {stats['gateway']['errors']}}}")
    print("[serve] sample result:")
    for c in sample[0].results[:3]:
        print(f"    {c.identifier:12s} {c.score:.4f}  {c.label[:40]}  {c.url}")
    return summary


if __name__ == "__main__":
    main()
