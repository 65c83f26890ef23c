"""Async batch-analytics job subsystem.

The port of ``repro.api.jobs``.  The executor thread runs the analytics
workloads on the engine's device, beside the scheduler's flush thread: on
the card both launch the top-k kernel, each through the thread-safe
staging pool of the index it reads.  The thread starts on the first
submit, so a forked worker starts it only after its own device is
resolved.

``JobManager`` turns the gateway into a submit → poll/stream batch API:

* **Lifecycle** — ``PENDING → RUNNING → DONE | FAILED | CANCELLED``,
  with a monotone progress fraction published between work slabs.
* **Bounded intake** — at most ``max_queued`` PENDING jobs; beyond
  that, submit fast-rejects with ``OVERLOADED`` + ``retry_after_s``
  *before* any analytics work, mirroring the scheduler's admission
  control (429 + Retry-After on the wire).
* **Single executor thread** — jobs are pinned to the worker process
  that accepted them and run one at a time on a daemon thread; the
  workload's ``tick`` boundary (between kernel slabs) is where progress
  is published, cancellation observed, and ``yield_s`` of sleep handed
  back to interactive traffic so serve-path p99 stays flat.
* **Result retention** — a finished job's rows are immutable; the
  newest ``keep_finished`` finished jobs are kept (older ones are
  evicted and report ``JOB_NOT_FOUND``, like any unknown id).
* **Multi-process visibility** — with a shared ``state_dir`` (the
  worker pool passes one), every submit/transition mirrors the job's
  public status to ``job-<id>.json`` (rows to ``job-<id>.rows.json`` on
  DONE) via atomic writes, so *any* worker answers polls for *any* job.
  Cancels from a non-owner drop a ``job-<id>.cancel`` marker the owner
  observes at its next tick. If a poll finds a PENDING/RUNNING job
  whose owner pid no longer exists (SIGKILL'd worker), the job is
  reported — and rewritten — as FAILED instead of hanging pollers;
  liveness is judged only by ``os.kill(pid, 0)``, never by heartbeat
  staleness, so a slow-but-alive worker is never falsely failed.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .schema import ApiError
from ..core import analytics

JOB_KINDS = ("knn-join", "drift", "compare")

#: status fields mirrored to the shared state file / returned to callers
_PUBLIC_FIELDS = ("job_id", "kind", "state", "progress", "ontology",
                  "model", "version", "version_b", "k", "submitted_at",
                  "wall_s", "total", "error", "summary", "owner_pid")


class JobCancelled(Exception):
    """Raised inside the executor when a cancel is observed mid-slab."""


class _Job:
    __slots__ = ("job_id", "kind", "spec", "state", "progress",
                 "submitted_at", "started_mono", "wall_s", "total",
                 "error", "summary", "rows", "owner_pid", "cancel_event",
                 "_last_persist")

    def __init__(self, job_id: str, kind: str, spec: Dict[str, Any]):
        self.job_id = job_id
        self.kind = kind
        self.spec = spec
        self.state = "PENDING"
        self.progress = 0.0
        self.submitted_at = time.time()
        self.started_mono: Optional[float] = None
        self.wall_s: Optional[float] = None
        self.total: Optional[int] = None
        self.error: Optional[str] = None
        self.summary: Optional[Dict[str, Any]] = None
        self.rows: Optional[List[List[Any]]] = None
        self.owner_pid = os.getpid()
        self.cancel_event = threading.Event()
        self._last_persist = 0.0

    def public(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id, "kind": self.kind, "state": self.state,
            "progress": round(self.progress, 6),
            "ontology": self.spec.get("ontology", ""),
            "model": self.spec.get("model"),
            "version": self.spec.get("version"),
            "version_b": self.spec.get("version_b"),
            "k": self.spec.get("k"),
            "submitted_at": self.submitted_at, "wall_s": self.wall_s,
            "total": self.total, "error": self.error,
            "summary": self.summary, "owner_pid": self.owner_pid,
        }


def _atomic_write(path: Path, payload: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(payload)
    os.replace(tmp, path)


def _pid_alive(pid: int) -> bool:
    """Liveness by signal-0 probe only. PermissionError means the pid
    exists (owned by someone else) — alive."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


class JobManager:
    """Submit/poll/cancel surface plus the background executor.

    ``engine`` is the gateway's ``ServingEngine``; analytics workloads
    go through its index cache, so jobs and interactive traffic share
    warm indexes.
    """

    def __init__(self, engine, *, max_queued: int = 8,
                 keep_finished: int = 64, yield_s: float = 0.002,
                 yield_duty: float = 1.0, slab: int = 64,
                 state_dir: Optional[str | Path] = None,
                 retry_after_s: float = 1.0,
                 persist_interval_s: float = 0.2):
        if max_queued < 1:
            raise ValueError(f"max_queued must be >= 1, got {max_queued}")
        self.engine = engine
        self.max_queued = int(max_queued)
        self.keep_finished = max(1, int(keep_finished))
        self.yield_s = float(yield_s)
        #: duty-cycle bound: each slab boundary sleeps at least
        #: ``yield_duty`` x the slab's own compute time, so a bulk job
        #: can never claim more than ``1/(1+duty)`` of the machine no
        #: matter how expensive its slabs are — the sleep scales with
        #: the contention the slab just caused. 1.0 caps a job at ~half
        #: the box; 0 falls back to the flat ``yield_s`` pause.
        self.yield_duty = max(0.0, float(yield_duty))
        self.slab = max(1, int(slab))
        self.retry_after_s = float(retry_after_s)
        self.persist_interval_s = float(persist_interval_s)
        self.state_dir = None if state_dir is None else Path(state_dir)
        if self.state_dir is not None:
            self.state_dir.mkdir(parents=True, exist_ok=True)
        self._jobs: Dict[str, _Job] = {}
        self._finished_order: List[str] = []
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._seq = 0
        self.counters: Dict[str, Any] = {
            "submitted": 0, "completed": 0, "failed": 0, "cancelled": 0,
            "rejected_overloaded": 0, "evicted": 0,
            "by_kind": {k: 0 for k in JOB_KINDS},
        }

    # ------------------------------------------------------------------ #
    # shared-state mirroring
    # ------------------------------------------------------------------ #
    def _state_path(self, job_id: str) -> Optional[Path]:
        if self.state_dir is None:
            return None
        return self.state_dir / f"job-{job_id}.json"

    def _persist(self, job: _Job, force: bool = False) -> None:
        path = self._state_path(job.job_id)
        if path is None:
            return
        now = time.monotonic()
        if not force and now - job._last_persist < self.persist_interval_s:
            return
        job._last_persist = now
        _atomic_write(path, json.dumps(job.public()))

    def _persist_rows(self, job: _Job) -> None:
        if self.state_dir is None or job.rows is None:
            return
        _atomic_write(self.state_dir / f"job-{job.job_id}.rows.json",
                      json.dumps(job.rows))

    def _read_shared(self, job_id: str) -> Optional[Dict[str, Any]]:
        """A *non-owner's* view of a job from the shared state dir, with
        the orphan rule applied: an in-flight job whose owner process is
        gone is rewritten and reported as FAILED."""
        path = self._state_path(job_id)
        if path is None or not path.exists():
            return None
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            return None
        if data.get("state") in ("PENDING", "RUNNING") and \
                int(data.get("owner_pid", 0)) != os.getpid() and \
                not _pid_alive(int(data.get("owner_pid", 0))):
            data["state"] = "FAILED"
            data["error"] = (f"worker process {data.get('owner_pid')} "
                             f"died before finishing the job")
            _atomic_write(path, json.dumps(data))
        return data

    def _cancel_marker(self, job_id: str) -> Optional[Path]:
        if self.state_dir is None:
            return None
        return self.state_dir / f"job-{job_id}.cancel"

    # ------------------------------------------------------------------ #
    # public surface
    # ------------------------------------------------------------------ #
    def submit(self, kind: str, spec: Dict[str, Any]) -> Dict[str, Any]:
        """Enqueue one validated job spec. Raises OVERLOADED *before*
        any analytics work when the PENDING bound is hit."""
        with self._lock:
            if self._closed:
                raise ApiError("SHUTTING_DOWN", "job intake is closed")
            pending = sum(1 for j in self._jobs.values()
                          if j.state == "PENDING")
            if pending >= self.max_queued:
                self.counters["rejected_overloaded"] += 1
                raise ApiError(
                    "OVERLOADED",
                    f"job queue full ({pending} pending >= "
                    f"{self.max_queued}); retry later",
                    details={"retry_after_s": self.retry_after_s,
                             "pending": pending,
                             "max_queued": self.max_queued})
            self._seq += 1
            job_id = f"j{os.getpid()}-{self._seq}"
            job = _Job(job_id, kind, spec)
            self._jobs[job_id] = job
            self.counters["submitted"] += 1
            self.counters["by_kind"][kind] += 1
            self._persist(job, force=True)
            self._ensure_thread()
            self._queue.put(job_id)
            return job.public()

    def status(self, job_id: str) -> Dict[str, Any]:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                return job.public()
        shared = self._read_shared(job_id)
        if shared is not None:
            return shared
        raise ApiError("JOB_NOT_FOUND", f"unknown job id {job_id!r}",
                       details={"job_id": job_id})

    def result_rows(self, job_id: str) -> Tuple[str, List[List[Any]]]:
        """``(kind, rows)`` of a DONE job; per-state errors otherwise."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                return self._check_result_state(job.public(), job.rows)
        shared = self._read_shared(job_id)
        if shared is not None:
            rows = None
            if shared.get("state") == "DONE":
                rp = (self.state_dir / f"job-{job_id}.rows.json"
                      if self.state_dir else None)
                if rp is not None and rp.exists():
                    try:
                        rows = json.loads(rp.read_text())
                    except (OSError, ValueError):
                        rows = None
            return self._check_result_state(shared, rows)
        raise ApiError("JOB_NOT_FOUND", f"unknown job id {job_id!r}",
                       details={"job_id": job_id})

    @staticmethod
    def _check_result_state(pub: Dict[str, Any],
                            rows: Optional[List[List[Any]]]
                            ) -> Tuple[str, List[List[Any]]]:
        state = pub.get("state")
        if state == "CANCELLED":
            raise ApiError("JOB_CANCELLED",
                           f"job {pub['job_id']} was cancelled; "
                           f"no results were materialized",
                           details={"job_id": pub["job_id"]})
        if state == "FAILED":
            raise ApiError("BAD_REQUEST",
                           f"job {pub['job_id']} failed: {pub.get('error')}",
                           details={"job_id": pub["job_id"],
                                    "state": "FAILED",
                                    "error": pub.get("error")})
        if state != "DONE" or rows is None:
            raise ApiError("BAD_REQUEST",
                           f"job {pub['job_id']} is not finished "
                           f"(state {state})",
                           details={"job_id": pub["job_id"], "state": state,
                                    "progress": pub.get("progress")})
        return pub["kind"], rows

    def cancel(self, job_id: str) -> Dict[str, Any]:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                if job.state == "PENDING":
                    job.state = "CANCELLED"
                    job.wall_s = 0.0
                    self.counters["cancelled"] += 1
                    self._note_finished_locked(job)
                    self._persist(job, force=True)
                    return job.public()
                if job.state == "RUNNING":
                    # observed at the executor's next slab boundary
                    job.cancel_event.set()
                    return job.public()
                raise ApiError(
                    "BAD_REQUEST",
                    f"cannot cancel job {job_id} in terminal state "
                    f"{job.state}",
                    details={"job_id": job_id, "state": job.state})
        shared = self._read_shared(job_id)
        if shared is not None:
            if shared.get("state") in ("PENDING", "RUNNING"):
                marker = self._cancel_marker(job_id)
                if marker is not None:
                    marker.touch()
                return shared
            raise ApiError(
                "BAD_REQUEST",
                f"cannot cancel job {job_id} in terminal state "
                f"{shared.get('state')}",
                details={"job_id": job_id, "state": shared.get("state")})
        raise ApiError("JOB_NOT_FOUND", f"unknown job id {job_id!r}",
                       details={"job_id": job_id})

    def list_jobs(self) -> List[Dict[str, Any]]:
        """This process's jobs, newest submission first."""
        with self._lock:
            jobs = sorted(self._jobs.values(),
                          key=lambda j: j.submitted_at, reverse=True)
            return [j.public() for j in jobs]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self.counters.items()}
            out["pending"] = sum(1 for j in self._jobs.values()
                                 if j.state == "PENDING")
            out["running"] = sum(1 for j in self._jobs.values()
                                 if j.state == "RUNNING")
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for job in self._jobs.values():
                if job.state == "RUNNING":
                    job.cancel_event.set()
        self._queue.put(None)
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    # ------------------------------------------------------------------ #
    # executor
    # ------------------------------------------------------------------ #
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run_loop, name="job-executor", daemon=True)
            self._thread.start()

    def _run_loop(self) -> None:
        while True:
            job_id = self._queue.get()
            if job_id is None or self._closed:
                return
            with self._lock:
                job = self._jobs.get(job_id)
                if job is None or job.state != "PENDING":
                    continue  # cancelled while queued, or evicted
                job.state = "RUNNING"
                job.started_mono = time.monotonic()
                self._persist(job, force=True)
            try:
                rows, summary = self._execute(job)
            except JobCancelled:
                self._finish(job, "CANCELLED")
            except ApiError as e:
                self._finish(job, "FAILED", error=f"{e.code}: {e.message}")
            except Exception as e:  # noqa: BLE001 — executor must survive
                self._finish(job, "FAILED", error=f"{type(e).__name__}: {e}")
            else:
                # publish the result fields under the lock: status() reads
                # them through public() and must never see DONE-in-progress
                # state (e.g. progress 1.0 with rows still unset)
                with self._lock:
                    job.rows = rows
                    job.summary = summary
                    job.total = len(rows)
                    job.progress = 1.0
                self._persist_rows(job)
                self._finish(job, "DONE")

    def _finish(self, job: _Job, state: str,
                error: Optional[str] = None) -> None:
        with self._lock:
            if error is not None:
                job.error = error
            job.state = state
            if job.started_mono is not None:
                job.wall_s = round(time.monotonic() - job.started_mono, 4)
            key = {"DONE": "completed", "FAILED": "failed",
                   "CANCELLED": "cancelled"}[state]
            self.counters[key] += 1
            self._note_finished_locked(job)
            self._persist(job, force=True)
        marker = self._cancel_marker(job.job_id)
        if marker is not None and marker.exists():
            try:
                marker.unlink()
            except OSError:
                pass

    def _note_finished_locked(self, job: _Job) -> None:
        """Retention: keep the newest ``keep_finished`` finished jobs of
        this process; evict (memory + shared files) beyond that.  Caller
        holds ``self._lock`` (the ``_locked`` suffix is the BIO001
        contract for that)."""
        self._finished_order.append(job.job_id)
        while len(self._finished_order) > self.keep_finished:
            victim = self._finished_order.pop(0)
            self._jobs.pop(victim, None)
            self.counters["evicted"] += 1
            if self.state_dir is not None:
                for suffix in (".json", ".rows.json", ".cancel"):
                    try:
                        (self.state_dir / f"job-{victim}{suffix}").unlink()
                    except OSError:
                        pass

    def _tick(self, job: _Job, expected_total: int):
        """The slab-boundary callback handed to analytics workloads:
        publish progress (monotone), observe cancellation (in-process
        event or cross-worker marker file), persist throttled, and yield
        to interactive traffic — sleeping ``yield_duty`` x the slab's
        own compute time (floored at ``yield_s``), so the job's CPU
        share is duty-cycle bounded and interactive p99 stays flat
        regardless of how expensive one slab is."""
        marker = self._cancel_marker(job.job_id)
        last = [time.monotonic()]

        def tick(frac: float) -> None:
            if job.cancel_event.is_set() or \
                    (marker is not None and marker.exists()):
                raise JobCancelled(job.job_id)
            with self._lock:
                job.progress = max(job.progress, min(frac, 1.0))
                if expected_total and job.total is None:
                    job.total = expected_total
            self._persist(job)
            now = time.monotonic()
            pause = max(self.yield_s, (now - last[0]) * self.yield_duty)
            if pause > 0:
                time.sleep(pause)
            last[0] = time.monotonic()

        return tick

    def _execute(self, job: _Job):
        spec = job.spec
        engine = self.engine
        if job.kind == "knn-join":
            classes = spec["classes"]
            tick = self._tick(job, len(classes))
            try:
                return analytics.bulk_knn_join(
                    engine, spec["ontology"], spec["model"], classes,
                    k=spec["k"], version=spec["version"], slab=self.slab,
                    tick=tick)
            except analytics.UnknownClasses as e:
                raise ApiError(
                    "UNKNOWN_CLASS", str(e.args[0]),
                    details={"missing": e.missing[:100],
                             "n_missing": len(e.missing)})
        if job.kind == "drift":
            tick = self._tick(job, 0)
            try:
                return analytics.drift_report(
                    engine, spec["ontology"], spec["model"],
                    spec["version"], spec["version_b"], k=spec["k"],
                    classes=spec.get("classes"), slab=self.slab, tick=tick)
            except analytics.UnknownClasses as e:
                raise ApiError(
                    "UNKNOWN_CLASS", str(e.args[0]),
                    details={"missing": e.missing[:100],
                             "n_missing": len(e.missing)})
        if job.kind == "compare":
            models = spec["models"]
            tick = self._tick(job, len(models))
            return analytics.model_compare(
                engine, spec["ontology"], spec["version"], models,
                sample=spec.get("sample"), tick=tick)
        raise ApiError("BAD_REQUEST", f"unknown job kind {job.kind!r}")
