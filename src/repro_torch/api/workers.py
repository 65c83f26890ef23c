"""Pre-forked multi-process HTTP serving — the zero-copy snapshot plane.

One Python process tops out well below what the card can answer: the
accept loop, the flush loop, the host gather into the kernel's staging
buffers and response serialization all contend on a single GIL.
Published snapshots are immutable and mmap-able (``SnapshotStore.
open_table``), which is exactly the shape for horizontal scaling on one
box: N worker processes, each a full Gateway/scheduler/HTTP stack on the
card, all serving read-only views of the *same* page-cache-resident
tables.

Architecture::

    WorkerPool (parent / supervisor; never touches the card)
      ├─ builds the CUDA kernels once (nvcc only, no CUDA context), so
      │  N workers do not each wait on a build
      ├─ anchor socket: SO_REUSEPORT, bound, NEVER listening — reserves
      │  the concrete port (also when the caller asked for port 0) while
      │  receiving no connections itself
      ├─ fork() × N  ─────────────►  worker process
      │                               ├─ own SO_REUSEPORT listening socket
      │                               │  (kernel load-balances accepts)
      │                               ├─ resolves its device, then
      │                               │  EmbeddingRegistry → ServingEngine
      │                               │  → Gateway → GatewayHTTPServer
      │                               │  (built AFTER fork: a CUDA context
      │                               │  never crosses a fork)
      │                               ├─ StoreWatcher: polls the store,
      │                               │  fires engine.invalidate when a
      │                               │  sealed version lands → publish
      │                               │  propagates to every worker
      │                               └─ stats dumper: periodic atomic
      │                                  snapshot to the state dir;
      │                                  /stats merges the siblings'
      └─ supervisor thread: per-pid waitpid(WNOHANG); restarts dead
         workers (SIGKILL mid-storm included) and records restarts

Where ``SO_REUSEPORT`` is unavailable the pool falls back to one
parent-bound listening socket that every fork inherits and accepts from
(contended accept, same correctness).

Fork safety: a child cannot use a CUDA driver its parent initialised, and
``torch.cuda.is_available()`` initialises it.  So the pool takes its
device as a *string* and only the child resolves it
(``repro_torch.device.resolve_device``); the parent may import torch
modules but must never have run a torch operation before it forks (the
CPU intra-op thread pool does not survive a fork either).
``launch.serve --workers`` therefore trains in a subprocess before the
pool starts.

The port of ``repro.api.workers``; every worker's batch jobs mirror into
one shared ``state_dir / "jobs"``.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.metrics import LatencyHistogram

#: seconds the pool's CLI and ``launch.serve --workers`` wait for /health
READY_TIMEOUT_S = 120.0
#: state-file names: worker-<idx>.json + supervisor.json
_WORKER_STATE = "worker-{idx}.json"
_SUPERVISOR_STATE = "supervisor.json"


def reuseport_available() -> bool:
    """True when this kernel supports SO_REUSEPORT load balancing."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        return True
    except OSError:
        return False


def make_listen_socket(host: str, port: int, *, reuseport: bool,
                       listen: bool = True,
                       backlog: int = 128) -> socket.socket:
    """A bound TCP socket; with ``listen=False`` it only reserves the
    port (the pool's anchor) and never receives connections."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuseport:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((host, port))
        if listen:
            s.listen(backlog)
    except BaseException:
        s.close()
        raise
    return s


def _atomic_write_json(path: Path, payload: Dict[str, Any]) -> None:
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)


# --------------------------------------------------------------------- #
#                         cross-worker stats merge                      #
# --------------------------------------------------------------------- #

def _merge_counter_dicts(a: Dict[str, Any], b: Dict[str, Any]) -> None:
    """Add b's numeric leaves into a (in place), recursing into dicts and
    unioning keys — the shape shared by scheduler/gateway/cache/http
    counter blocks."""
    for k, v in b.items():
        if isinstance(v, dict):
            _merge_counter_dicts(a.setdefault(k, {}), v)
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            a.setdefault(k, v)
        else:
            a[k] = a.get(k, 0) + v


def merge_stats_wires(wires: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold N workers' ``/stats`` wire bodies into one pool-wide body.

    Counters add; the fixed-bucket ``LatencyHistogram`` snapshots merge
    exactly by adding bucket counts (``LatencyHistogram.merge_snapshots``);
    per-route histogram maps union their routes.  ``cache.capacity`` adds
    too: it is the pool's total index budget."""
    if not wires:
        return {}
    sched: Dict[str, Any] = {}
    cache: Dict[str, Any] = {}
    gw: Dict[str, Any] = {}
    lat_routes: Dict[str, List[Dict[str, Any]]] = {}
    sched_lat: List[Dict[str, Any]] = []
    for w in wires:
        s = dict(w.get("scheduler") or {})
        snap = s.pop("latency_ms", None)
        if snap is not None:
            sched_lat.append(snap)
        _merge_counter_dicts(sched, s)
        _merge_counter_dicts(cache, w.get("cache") or {})
        _merge_counter_dicts(gw, w.get("gateway") or {})
        for route, snap in (w.get("latency") or {}).items():
            lat_routes.setdefault(route, []).append(snap)
    if sched_lat:
        sched["latency_ms"] = LatencyHistogram.merge_snapshots(sched_lat)
    return {
        "type": "stats_response",
        "scheduler": sched,
        "cache": cache,
        "gateway": gw,
        "latency": {route: LatencyHistogram.merge_snapshots(snaps)
                    for route, snaps in sorted(lat_routes.items())},
    }


def read_worker_states(state_dir: str | Path,
                       skip_idx: Optional[int] = None
                       ) -> List[Dict[str, Any]]:
    """Every worker's latest state dump under ``state_dir`` (pid, port,
    device, adoptions, kernel launches, transport counters, stats), but
    worker ``skip_idx``'s."""
    out = []
    for p in sorted(Path(state_dir).glob("worker-*.json")):
        try:
            state = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue                    # mid-replace or torn — skip
        if skip_idx is not None and state.get("idx") == skip_idx:
            continue
        out.append(state)
    return out


# --------------------------------------------------------------------- #
#                            store watcher                              #
# --------------------------------------------------------------------- #

class StoreWatcher:
    """Publish→invalidate propagation for processes that don't run the
    updater: polls the snapshot store and fires ``engine.invalidate``
    when a new version becomes adoptable.

    A version is adoptable when it is *sealed* (the updater's
    ``registry.seal`` after all models are on disk); for ontologies with
    no seal markers at all (pre-seal stores, hand-published registries)
    the newest version with at least one complete model — metadata.json
    present — is adopted instead.  Polling cost is a couple of
    ``stat(2)`` calls per ontology per tick."""

    def __init__(self, engine, interval_s: float = 0.25):
        self.engine = engine
        self.interval_s = interval_s
        self._seen: Dict[str, Optional[str]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: adoption counter (exposed in worker state dumps)
        self.adoptions = 0
        # baseline: don't fire for what is already current at start
        for ont in self._store().ontologies():
            self._seen[ont] = self._candidate(ont)

    def _store(self):
        return self.engine.registry.store

    def _candidate(self, ontology: str) -> Optional[str]:
        store = self._store()
        sealed = store.sealed_versions(ontology)
        if sealed:
            return sealed[-1]
        for v in reversed(store.versions(ontology)):
            for m in store.models(ontology, v):
                if (store._dir(ontology, v, m) / "metadata.json").exists():
                    return v
        return None

    def poll_once(self) -> List[str]:
        """One scan; returns the ontologies whose pointer moved."""
        moved = []
        for ont in self._store().ontologies():
            v = self._candidate(ont)
            if v is not None and v != self._seen.get(ont):
                self.engine.invalidate(ont, v)
                self._seen[ont] = v
                self.adoptions += 1
                moved.append(ont)
        return moved

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                pass        # a torn half-written dir must not kill the loop

    def start(self) -> "StoreWatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="store-watcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# --------------------------------------------------------------------- #
#                            worker process                             #
# --------------------------------------------------------------------- #

def _worker_main(idx: int, registry_root: str, host: str, port: int,
                 state_dir: Path, *, inherited: Optional[socket.socket],
                 device: str, max_batch: int, flush_after_ms: float,
                 cache_capacity: int, watch_interval_s: float,
                 stats_interval_s: float,
                 max_pending: Optional[int] = None,
                 result_cache_entries: int = 4096,
                 result_cache_bytes: int = 32 << 20,
                 max_jobs_queued: int = 8) -> None:
    """Body of one worker process (runs post-fork; exits via os._exit).

    Resolves its device and builds the full serving stack from scratch —
    registry, engine, gateway, HTTP server — because no CUDA context may
    cross the fork.  The embedding tables themselves arrive by mmap, so
    "from scratch" costs an open+map, not a copy."""
    # the child must not run the parent's signal handlers
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    from ..core.registry import EmbeddingRegistry
    from ..core.serving import ServingEngine
    from ..device import resolve_device
    from ..kernels import topk_similarity
    from .gateway import Gateway
    from .http import GatewayHTTPServer

    dev = resolve_device(device)
    registry = EmbeddingRegistry(registry_root)
    engine = ServingEngine(registry, cache_capacity=cache_capacity,
                           device=dev)
    # jobs_state_dir is shared across the pool: each worker's JobManager
    # mirrors its jobs there, so any worker can answer status/result/
    # cancel for a job pinned to a sibling — and report a SIGKILL'd
    # sibling's in-flight jobs as FAILED (the orphan rule).  The job
    # executor thread starts on the first submit, after ``dev`` above.
    gw = Gateway(engine, max_batch=max_batch, flush_after_ms=flush_after_ms,
                 max_pending=max_pending,
                 result_cache_entries=result_cache_entries,
                 result_cache_bytes=result_cache_bytes,
                 max_jobs_queued=max_jobs_queued,
                 jobs_state_dir=state_dir / "jobs")

    if inherited is not None:
        sock = inherited                      # fallback: contended accept
    else:
        sock = make_listen_socket(host, port, reuseport=True)

    def stats_hook(wire: Dict[str, Any]) -> Dict[str, Any]:
        siblings = read_worker_states(state_dir, skip_idx=idx)
        merged = merge_stats_wires(
            [wire] + [s["stats"] for s in siblings if s.get("stats")])
        http_counts: Dict[str, Any] = {}
        # locked accessor: copying the live dict races request threads
        _merge_counter_dicts(http_counts, server.http_counts())
        for s in siblings:
            _merge_counter_dicts(http_counts, s.get("http") or {})
        # 304 latency histograms merge by bucket-adding snapshots —
        # explicitly, never through _merge_counter_dicts (it would keep
        # the first worker's bucket list and drop the rest)
        nm_snaps = [server.not_modified_latency.snapshot()]
        for s in siblings:
            snap = (s.get("http_latency") or {}).get("not_modified")
            if snap:
                nm_snaps.append(snap)
        http_counts["latency_ms"] = {
            "not_modified": LatencyHistogram.merge_snapshots(nm_snaps)}
        sup: Dict[str, Any] = {}
        try:
            sup = json.loads((state_dir / _SUPERVISOR_STATE).read_text())
        except (OSError, json.JSONDecodeError):
            pass
        merged["workers"] = {
            "count": 1 + len(siblings),
            "pids": sorted([os.getpid()] + [s["pid"] for s in siblings
                                            if s.get("pid")]),
            "restarts": sup.get("restarts", 0),
            "http": http_counts,
        }
        return merged

    server = GatewayHTTPServer(gw, (host, port), sock=sock,
                               stats_hook=stats_hook)
    watcher = StoreWatcher(engine, interval_s=watch_interval_s).start()

    def dump_state() -> None:
        # /stats through gw.handle would inflate the request counters the
        # dump is reporting — snapshot through the handler directly
        from .schema import StatsRequest, to_wire
        _atomic_write_json(state_dir / _WORKER_STATE.format(idx=idx), {
            "idx": idx, "pid": os.getpid(), "port": server.port,
            "ts": time.time(), "adoptions": watcher.adoptions,
            "device": str(dev),
            # this process's top-k launches: what shows a worker served
            # through the kernel on the card
            "kernel_launches": dict(topk_similarity.launches),
            "http": server.http_counts(),
            "http_latency": {
                "not_modified": server.not_modified_latency.snapshot()},
            "stats": to_wire(gw._handle_stats(StatsRequest())),
        })

    stop_dumping = threading.Event()
    parent_pid = os.getppid()

    def dump_loop() -> None:
        while not stop_dumping.wait(stats_interval_s):
            try:
                dump_state()
            except Exception:
                # a torn sibling state file or a full disk must not kill
                # the dump loop — the next interval retries
                pass
            # orphan guard: if the supervisor was SIGKILLed (a crashed
            # driver, a shell timeout), nothing will ever reap or stop
            # this worker — shut down instead of serving forever
            if os.getppid() != parent_pid:
                threading.Thread(target=server.shutdown,
                                 daemon=True).start()
                return

    dump_state()
    threading.Thread(target=dump_loop, name="stats-dump",
                     daemon=True).start()

    def on_term(signum, frame):
        # shutdown() blocks until serve_forever exits — it must not run
        # on the thread serve_forever occupies (signals land on main)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)

    try:
        server.serve_forever()
    except Exception:
        # an accept-loop crash still falls through to the cleanup below;
        # the supervisor sees the exit and restarts the worker
        pass
    finally:
        stop_dumping.set()
        watcher.stop()
        try:
            dump_state()                      # final counters for mergers
        except Exception:
            # best-effort: losing the final counter dump only understates
            # the pool-merged /stats, never blocks worker exit
            pass
        try:
            server.server_close()
            gw.close()
        except Exception:
            # best-effort close on the way into os._exit — the OS reaps
            # the socket and threads regardless
            pass
        os._exit(0)


# --------------------------------------------------------------------- #
#                         the pool / supervisor                         #
# --------------------------------------------------------------------- #

class WorkerPool:
    """N pre-forked HTTP serving workers over one snapshot store.

    The parent never serves traffic and never touches the card: it
    builds the kernels (for ``device="cuda"``), reserves the port, forks,
    then supervises — a worker that dies (crash, SIGKILL) is reaped via
    per-pid ``waitpid(WNOHANG)`` (never ``waitpid(-1)``, which would
    steal unrelated children from an embedding process) and replaced
    within one supervision tick.  Connections sitting in a dead worker's
    accept queue are lost — the client retries and the kernel routes the
    new connection to a live worker; that is the "at most one retryable
    error" contract.

    ``device`` is a string (``"cuda"`` or ``"cpu"``) that each worker
    resolves after the fork.
    """

    def __init__(self, registry_root: str | Path, port: int = 0,
                 host: str = "127.0.0.1", workers: int = 2, *,
                 device: str = "cuda",
                 max_batch: int = 64, flush_after_ms: float = 2.0,
                 cache_capacity: int = 8,
                 max_pending: Optional[int] = None,
                 result_cache_entries: int = 4096,
                 result_cache_bytes: int = 32 << 20,
                 max_jobs_queued: int = 8,
                 state_dir: Optional[str | Path] = None,
                 use_reuseport: Optional[bool] = None,
                 watch_interval_s: float = 0.25,
                 stats_interval_s: float = 0.5,
                 restart: bool = True,
                 supervise_interval_s: float = 0.05):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if not isinstance(device, str) or device.split(":")[0] not in (
                "cuda", "cpu"):
            raise ValueError(f"device must be the string 'cuda' or 'cpu' "
                             f"(each worker resolves it after the fork), "
                             f"got {device!r}")
        self.registry_root = str(registry_root)
        self.host = host
        self.requested_port = port
        self.workers = workers
        self.device = device
        self.max_batch = max_batch
        self.flush_after_ms = flush_after_ms
        self.cache_capacity = cache_capacity
        self.max_pending = max_pending
        self.result_cache_entries = result_cache_entries
        self.result_cache_bytes = result_cache_bytes
        self.max_jobs_queued = max_jobs_queued
        self.restart = restart
        self.watch_interval_s = watch_interval_s
        self.stats_interval_s = stats_interval_s
        self.supervise_interval_s = supervise_interval_s
        self.reuseport = (reuseport_available() if use_reuseport is None
                          else use_reuseport)
        self.state_dir = Path(state_dir) if state_dir is not None else Path(
            tempfile.mkdtemp(prefix="biokg-workers-"))
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self._anchor: Optional[socket.socket] = None
        self._pids: Dict[int, int] = {}       # idx -> pid
        self.restarts = 0
        self._stopping = False
        self._lock = threading.Lock()
        self._supervisor: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # ----------------------------- lifecycle --------------------------- #
    def start(self) -> "WorkerPool":
        if self._anchor is not None:
            return self
        # warm sys.modules before forking: children then never touch the
        # import machinery (whose lock another parent thread could hold at
        # fork time). Importing torch *modules* here is fork-safe — only
        # a CUDA context or the CPU thread pool is not, and nothing below
        # creates either.
        from ..core.registry import EmbeddingRegistry      # noqa: F401
        from ..core.serving import ServingEngine           # noqa: F401
        from ..device import resolve_device                # noqa: F401
        from ..kernels import _build, topk_similarity      # noqa: F401
        from .gateway import Gateway                       # noqa: F401
        from .http import GatewayHTTPServer                # noqa: F401
        from .schema import StatsRequest, to_wire          # noqa: F401
        if self.device.startswith("cuda"):
            # nvcc under the build's file lock, no library loaded: the
            # workers find the kernels built instead of each waiting
            _build.build_all()
        if self.reuseport:
            # bound but never listening: reserves the concrete port (incl.
            # resolving port 0) yet receives no connections — every accept
            # goes to a worker's own listening socket
            self._anchor = make_listen_socket(
                self.host, self.requested_port, reuseport=True, listen=False)
        else:
            # fallback: one parent-bound listener every fork inherits
            self._anchor = make_listen_socket(
                self.host, self.requested_port, reuseport=False, listen=True)
        self.port = self._anchor.getsockname()[1]
        self._stopping = False
        for idx in range(self.workers):
            self._spawn(idx)
        self._write_supervisor_state()
        self._supervisor = threading.Thread(
            target=self._supervise, name="worker-supervisor", daemon=True)
        self._supervisor.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def pids(self) -> List[int]:
        with self._lock:
            return sorted(self._pids.values())

    def _spawn(self, idx: int) -> int:
        pid = os.fork()
        if pid == 0:
            try:
                if self.reuseport and self._anchor is not None:
                    # the child serves from its own REUSEPORT socket; the
                    # inherited anchor fd is dead weight
                    self._anchor.close()
                _worker_main(
                    idx, self.registry_root, self.host, int(self.port),
                    self.state_dir,
                    inherited=None if self.reuseport else self._anchor,
                    device=self.device,
                    max_batch=self.max_batch,
                    flush_after_ms=self.flush_after_ms,
                    cache_capacity=self.cache_capacity,
                    watch_interval_s=self.watch_interval_s,
                    stats_interval_s=self.stats_interval_s,
                    max_pending=self.max_pending,
                    result_cache_entries=self.result_cache_entries,
                    result_cache_bytes=self.result_cache_bytes,
                    max_jobs_queued=self.max_jobs_queued)
            finally:
                # _worker_main exits via its own os._exit(0); reaching
                # here means it raised before serving
                os._exit(1)
        with self._lock:
            self._pids[idx] = pid
        return pid

    def _write_supervisor_state(self) -> None:
        import torch
        with self._lock:
            state = {"pid": os.getpid(), "port": self.port,
                     "workers": dict(self._pids), "restarts": self.restarts,
                     "reuseport": self.reuseport, "device": self.device,
                     # must stay False: the parent never touches the card
                     "cuda_initialized": torch.cuda.is_initialized(),
                     "ts": time.time()}
        try:
            _atomic_write_json(self.state_dir / _SUPERVISOR_STATE, state)
        except OSError:
            pass

    def _supervise(self) -> None:
        while True:
            if self._stopping:
                return
            for idx, pid in list(self._pids.items()):
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    done = pid                # already reaped elsewhere
                if done and not self._stopping:
                    if not self.restart:
                        with self._lock:
                            self._pids.pop(idx, None)
                        continue
                    self._spawn(idx)
                    with self._lock:
                        self.restarts += 1
                    self._write_supervisor_state()
            time.sleep(self.supervise_interval_s)

    def wait_ready(self, timeout_s: float = 30.0) -> None:
        """Block until the pool answers /health over a real socket."""
        import urllib.request
        deadline = time.monotonic() + timeout_s
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                        f"{self.url}/health", timeout=2.0) as resp:
                    if resp.status == 200:
                        return
            except Exception as e:
                last = e
            time.sleep(0.05)
        raise TimeoutError(
            f"worker pool not serving on {self.url} after {timeout_s}s "
            f"(last error: {last})")

    def kill_one(self, sig: int = signal.SIGKILL) -> int:
        """Kill one worker (crash-drill helper); returns its pid."""
        pid = self.pids()[0]
        os.kill(pid, sig)
        return pid

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stopping = True
        if self._supervisor is not None:
            self._supervisor.join(timeout=timeout_s)
            self._supervisor = None
        with self._lock:
            pids = dict(self._pids)
            self._pids.clear()
        for pid in pids.values():
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + timeout_s
        for pid in pids.values():
            while time.monotonic() < deadline:
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    break
                if done:
                    break
                time.sleep(0.02)
            else:
                try:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                except (ProcessLookupError, ChildProcessError):
                    pass
        if self._anchor is not None:
            self._anchor.close()
            self._anchor = None

    def __enter__(self) -> "WorkerPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --------------------------------------------------------------------- #
#                                  CLI                                  #
# --------------------------------------------------------------------- #

def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.api.workers --registry R --port P --workers N``

    Serves an existing registry (publish first — e.g. via
    ``launch.train`` or ``launch.serve``) on ``--device`` (default: the
    card) and prints one ``READY`` line once /health answers, so drivers
    can wait on stdout.  The process is driver-attached by design: if the
    launching process dies without stopping it (SIGKILL, shell timeout),
    the pool notices the reparent and shuts itself down rather than leak
    forever — run ``launch.serve --workers`` for a standalone service."""
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api.workers")
    ap.add_argument("--registry", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where each worker's top-k runs: cuda (the "
                         "kernel) or cpu (its plain PyTorch version)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--flush-after-ms", type=float, default=2.0)
    ap.add_argument("--state-dir", default=None)
    ap.add_argument("--watch-interval-ms", type=float, default=250.0)
    ap.add_argument("--stats-interval-ms", type=float, default=500.0)
    ap.add_argument("--max-pending", type=int, default=None,
                    help="per-worker scheduler intake bound; past it "
                         "submissions fast-reject with HTTP 429")
    ap.add_argument("--cache-entries", type=int, default=4096,
                    help="result-cache entry bound per worker (0 disables)")
    ap.add_argument("--cache-bytes", type=int, default=32 << 20,
                    help="result-cache byte bound per worker (0 disables)")
    ap.add_argument("--max-jobs-queued", type=int, default=8,
                    help="per-worker batch-job queue bound; past it "
                         "submissions fast-reject with HTTP 429")
    ap.add_argument("--no-reuseport", action="store_true",
                    help="force the inherited-listener fallback")
    args = ap.parse_args(argv)

    pool = WorkerPool(
        args.registry, port=args.port, host=args.host, workers=args.workers,
        device=args.device,
        max_batch=args.max_batch, flush_after_ms=args.flush_after_ms,
        max_pending=args.max_pending,
        result_cache_entries=args.cache_entries,
        result_cache_bytes=args.cache_bytes,
        max_jobs_queued=args.max_jobs_queued,
        state_dir=args.state_dir,
        use_reuseport=False if args.no_reuseport else None,
        watch_interval_s=args.watch_interval_ms / 1e3,
        stats_interval_s=args.stats_interval_ms / 1e3)
    pool.start()
    try:
        # on the card a worker creates its CUDA context and loads the
        # kernels before it answers
        pool.wait_ready(READY_TIMEOUT_S)
    except TimeoutError as e:
        print(f"[workers] {e}", file=sys.stderr)
        pool.stop()
        raise SystemExit(1)
    print(f"READY port={pool.port} pids={','.join(map(str, pool.pids()))} "
          f"reuseport={int(pool.reuseport)} state_dir={pool.state_dir}",
          flush=True)

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    parent_pid = os.getppid()
    while not stop.is_set():
        stop.wait(0.2)
        # orphan guard: the launching driver died without stopping us
        # (SIGKILL, shell timeout) — take the pool down with it
        if os.getppid() != parent_pid:
            break
    pool.stop()
    try:
        print("[workers] stopped", flush=True)
    except OSError:
        pass            # driver died first: stdout pipe is already gone


if __name__ == "__main__":
    main()
