"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's serving path the way a user does and holds every
kernel to its plain PyTorch version on the card.  Phases, in order; any
failure exits non-zero:

  1. build    compile ``src/repro_torch/kernels/csrc/*.cu`` (nvcc, sm_90a)
  2. kernels  the top-k kernel against its plain version: the edge grid,
              exact duplicate rows, N in {40k, 100k} x Q in {1, 32, 64} x
              k in {1, 10, 64, 65, 2000, N}, streamed and device-resident,
              and 1024-row slabs (40 slabs at 40k)
  3. serve    two versions of a 40,000 x 200 GO-size snapshot published
              through the port's registry; ``repro_torch.launch.serve``
              in client-session mode, then HTTP over the gateway, every
              answer checked against the plain version
  4. numbers  kernel, plain, library and host-to-device times (CUDA
              events) at N = 40k and 100k, beside the card's bound

Run from the repository root with no arguments::

    python3 chip_smoke.py

It prints JSON lines as it goes, then the card's name and power limit,
the kernels line, and last ``{"ok": true, "device": {...}}``.
``--phases`` runs a subset (``build,kernels`` is a quick compile check);
``--out PATH`` also writes every result to one JSON file.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20250907
D = 200                     # PAPER_DIM of the GO workload
GO_ROWS = 40_000            # configs/go_kge.py CONFIG.n_terms
SCALE_ROWS = 100_000        # configs/go_kge.py SCALE.n_terms
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 on the CUDA cores
SCORE_TOL = 1e-5            # kernel vs plain scores (fp32 sums in another order)
TIE_TOL = 1e-6              # runs of scores this close may order ids freely
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/topk_cosine.cu"
REPLACES = "src/repro/kernels/topk_similarity.py:78"
SMALL_ENTRY = ("topk_select_chunks", "topk_merge_running")
LARGE_ENTRY = ("topk_score_keys", "topk_bitonic_global",
               "topk_bitonic_shared", "topk_gather")
#: the device kernels in topk_cosine.cu, as the profiler names them
_KERNEL_NAMES = ("select_chunks", "merge_running", "score_keys",
                 "bitonic_global", "bitonic_shared", "gather")

RESULTS: dict = {"phases": {}}
#: the card; the phases take it from here
DEV = "cuda"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------- #
# comparisons
# --------------------------------------------------------------------- #
def _ids_agree(a: np.ndarray, b: np.ndarray, s_plain: np.ndarray):
    """ids equal position by position, except inside runs of plain scores
    closer than TIE_TOL, where only the sets must match; a run cut by the
    end of the row may hold different members.  Returns the number of
    runs that needed the set rule, or raises."""
    if np.array_equal(a, b):
        return 0
    n = len(a)
    brk = np.ones(n, bool)
    brk[1:] = (s_plain[:-1] - s_plain[1:]) >= TIE_TOL
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], n)
    run_of = np.cumsum(brk) - 1
    relaxed = 0
    for rid in np.unique(run_of[a != b]):
        lo, hi = starts[rid], ends[rid]
        if hi == n:
            relaxed += 1           # the cut-off falls inside a near-tie
            continue
        check(np.array_equal(np.sort(a[lo:hi]), np.sort(b[lo:hi])),
              f"ids differ outside a near-tie run at [{lo}, {hi})")
        relaxed += 1
    check(len(np.unique(a)) == n, "duplicate ids in the kernel's result")
    return relaxed


def compare(got, want, note: str) -> dict:
    s, i, v = (t.cpu().numpy() for t in got)
    sr, ir, vr = (t.cpu().numpy() for t in want)
    check(np.array_equal(v, vr), f"{note}: valid {v} != {vr}")
    err, relaxed = 0.0, 0
    for r in range(s.shape[0]):
        n = int(v[r])
        if n == 0:
            continue
        e = float(np.abs(s[r, :n] - sr[r, :n]).max())
        check(e <= SCORE_TOL, f"{note}: row {r} score error {e}")
        err = max(err, e)
        relaxed += _ids_agree(i[r, :n], ir[r, :n], sr[r, :n])
    return {"max_abs_err": err, "tie_runs_by_set": relaxed}


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
def go_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D), dtype=np.float32)
    ids = [f"GO:{i:07d}" for i in range(n)]
    labels = [f"go term {i:06d} {seed % 97}" for i in range(n)]
    return ids, labels, emb


def unit_rows(table: np.ndarray, norms: np.ndarray, rows) -> np.ndarray:
    sub = np.asarray(table[rows], dtype=np.float32)
    n = np.asarray(norms[rows], dtype=np.float32)
    return sub / np.maximum(n[..., None], 1e-12)


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "compile_s": _build.last_build_s,
           "libraries": {k: str(p.relative_to(ROOT)) for k, p in libs.items()}}
    emit(out)
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas] {line.strip()}")
    return out


def phase_kernels(store_tables) -> dict:
    import torch
    from repro_torch.kernels import ops, ref, topk_similarity as ts

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    errs = {"small": 0.0, "large": 0.0}
    cases = 0
    relaxed_total = 0

    def record(k_c, res):
        nonlocal cases, relaxed_total
        path = "small" if k_c <= ts.SMALL_K_MAX else "large"
        errs[path] = max(errs[path], res["max_abs_err"])
        relaxed_total += res["tie_runs_by_set"]
        cases += 1

    # -- the edge grid of tests/test_blocked_topk.py, both paths -------- #
    grid = [(2, 21, 16, 12, 8), (3, 21, 16, 5, 8), (2, 16, 8, 16, 8),
            (1, 7, 8, 10, 8), (2, 64, 32, 64, 16)]
    for Q, N, d, k, block in grid:
        q = rng.standard_normal((Q, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        e = rng.standard_normal((N, d)).astype(np.float32)
        nrm = np.linalg.norm(e, axis=1).astype(np.float32)
        excl = np.array([N - 1 if j % 2 == 0 else -1 for j in range(Q)],
                        np.int32)
        want = ref.topk_cosine_blocked_ref(
            torch.from_numpy(q).to(dev), torch.from_numpy(e).to(dev), k,
            exclude_rows=torch.from_numpy(excl).to(dev),
            norms=torch.from_numpy(nrm).to(dev), block_n=block)
        got = ops.topk_cosine(q, e, k, exclude_rows=excl, norms=nrm,
                              block_rows=block, device=dev)
        record(min(k, N), compare(got, want, f"edge stream {Q, N, d, k}"))
        got = ops.topk_cosine(q, torch.from_numpy(e).to(dev), k,
                              exclude_rows=excl, norms=nrm)
        record(min(k, N), compare(got, want, f"edge device {Q, N, d, k}"))
    torch.cuda.synchronize()

    # -- exact duplicate rows: integer data, every score exact ---------- #
    n_dup, q_dup = 5000, 8
    base = rng.integers(-2, 3, size=(n_dup // 2, D)).astype(np.float32)
    e = np.concatenate([base, base])            # row j == row j + n/2
    q = rng.integers(-2, 3, size=(q_dup, D)).astype(np.float32)
    ones = np.ones(n_dup, np.float32)
    for k in (10, 64, 65, 300):
        want = ref.topk_cosine_blocked_ref(
            torch.from_numpy(q).to(dev), torch.from_numpy(e).to(dev), k,
            norms=torch.from_numpy(ones).to(dev), block_n=1024)
        for got in (ops.topk_cosine(q, e, k, norms=ones, block_rows=1024,
                                    device=dev),
                    ops.topk_cosine(q, torch.from_numpy(e).to(dev), k,
                                    norms=ones)):
            s, i, v = (t.cpu().numpy() for t in got)
            sr, ir, vr = (t.cpu().numpy() for t in want)
            check(np.array_equal(v, vr) and np.array_equal(i, ir)
                  and np.array_equal(s, sr),
                  f"duplicate rows k={k}: ties not resolved to the lower "
                  f"index exactly")
            cases += 1
    torch.cuda.synchronize()

    # -- GO and SCALE sizes, streamed from the store and device-resident - #
    for n_rows, (table, norms) in store_tables.items():
        table_dev = torch.from_numpy(np.array(table)).to(dev)
        norms_dev = torch.from_numpy(np.array(norms)).to(dev)
        for Q in (1, 32, 64):
            rows = rng.choice(n_rows, size=Q, replace=False)
            q = unit_rows(table, norms, rows)
            excl = rows.astype(np.int32)
            q_dev = torch.from_numpy(q).to(dev)
            x_dev = torch.from_numpy(excl).to(dev)
            for k in (1, 10, 64, 65, 2000, n_rows):
                k_c = min(k, n_rows)
                want = ref.topk_cosine_blocked_ref(
                    q_dev, table_dev, k, exclude_rows=x_dev, norms=norms_dev,
                    block_n=ops.STREAM_BLOCK_ROWS)
                got = ops.topk_cosine(q, table, k, exclude_rows=excl,
                                      norms=norms, device=dev)
                record(k_c, compare(got, want, f"stream N={n_rows} Q={Q} k={k}"))
                got = ops.topk_cosine(q, table_dev, k, exclude_rows=excl,
                                      norms=norms)
                record(k_c, compare(got, want, f"device N={n_rows} Q={Q} k={k}"))
                del want, got
            torch.cuda.synchronize()
        # 1024-row slabs: 40 slabs at 40k, staging buffers reused 20 times
        if n_rows == GO_ROWS:
            for Q, k in ((32, 10), (64, 2000)):
                rows = rng.choice(n_rows, size=Q, replace=False)
                q = unit_rows(table, norms, rows)
                excl = rows.astype(np.int32)
                want = ref.topk_cosine_blocked_ref(
                    torch.from_numpy(q).to(dev), table_dev, k,
                    exclude_rows=torch.from_numpy(excl).to(dev),
                    norms=norms_dev, block_n=1024)
                before = ops.stream_stats["blocks"]
                got = ops.topk_cosine(q, table, k, exclude_rows=excl,
                                      norms=norms, block_rows=1024, device=dev)
                check(ops.stream_stats["blocks"] - before == 40,
                      "1024-row slabs: expected 40 slabs at 40k rows")
                record(k, compare(got, want, f"slabs1024 Q={Q} k={k}"))
        del table_dev, norms_dev
        torch.cuda.synchronize()
    out = {"phase": "kernels", "cases": cases,
           "max_abs_err_small": errs["small"],
           "max_abs_err_large": errs["large"],
           "tie_runs_compared_by_set": relaxed_total,
           "tolerance": {"scores": SCORE_TOL, "tie_runs": TIE_TOL}}
    emit(out)
    return out


def _http_json(base: str, path: str, params: dict, retries: int = 3):
    url = f"{base}{path}?{urllib.parse.urlencode(params)}"
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
        except (ConnectionError, urllib.error.URLError):
            if attempt == retries - 1:
                raise
            time.sleep(0.1)


def phase_serve(registry_root: str, served: dict) -> dict:
    """The main path: launch.serve (client session) then HTTP."""
    import torch
    from repro_torch.api import Gateway, serve_http
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kernels import ops, ref, topk_similarity as ts
    from repro_torch.launch import serve

    dev = torch.device(DEV)
    ids, labels, emb = served["ids"], served["labels"], served["emb"]
    norms = np.linalg.norm(emb, axis=1).astype(np.float32)
    emb_dev = torch.from_numpy(emb).to(dev)
    norms_dev = torch.from_numpy(norms).to(dev)

    ts.reset_launches()
    ops.reset_stream_stats()
    # ---------------- main path: client session ----------------------- #
    session = serve.main(["--registry", registry_root, "--requests", "512",
                          "--batch", "32", "--threads", "8",
                          "--device", DEV])
    torch.cuda.synchronize()
    after_session = dict(ts.launches)
    check(sum(after_session[n] for n in SMALL_ENTRY) > 0,
          "serve session launched no top-k kernel")

    # ---------------- main path: HTTP over the gateway ---------------- #
    engine = ServingEngine(EmbeddingRegistry(registry_root), device=DEV)
    gw = Gateway(engine, max_batch=32, flush_after_ms=2.0)
    server = serve_http(gw, port=0)
    rng = np.random.default_rng(SEED + 1)
    n = len(ids)
    counts = {"sim": 0, "closest-concepts": 0, "get-vector": 0,
              "download": 0, "autocomplete": 0}
    sim_bits_exact = 0
    lat_lock = threading.Lock()
    closest_answers = []
    try:
        base = server.url

        def closest(row: int, k: int):
            st, body = _http_json(base, "/closest-concepts/go/transe",
                                  {"query": ids[row], "k": k})
            with lat_lock:
                closest_answers.append((row, k, st, body))

        jobs = [(int(r), 10) for r in rng.integers(0, n, 160)]
        jobs += [(int(r), 2000) for r in rng.integers(0, n, 16)]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda a: closest(*a), jobs))
        torch.cuda.synchronize()
        for row, k, st, body in closest_answers:
            check(st == 200, f"closest-concepts {ids[row]} k={k}: {body}")
            q = unit_rows(emb, norms, [row])
            s_ref, i_ref, v_ref = ref.topk_cosine_blocked_ref(
                torch.from_numpy(q).to(dev), emb_dev, k,
                exclude_rows=torch.tensor([row], dtype=torch.int32,
                                          device=dev),
                norms=norms_dev, block_n=ops.STREAM_BLOCK_ROWS)
            nv = int(v_ref[0])
            hits = body["results"]
            check(len(hits) == nv, f"closest {ids[row]}: {len(hits)} hits")
            s_got = np.array([h["score"] for h in hits], np.float64)
            i_got = np.array([int(h["identifier"][3:]) for h in hits])
            s_plain = s_ref[0, :nv].cpu().numpy().astype(np.float64)
            check(float(np.abs(s_got - s_plain).max()) <= SCORE_TOL,
                  f"closest {ids[row]}: scores off")
            _ids_agree(i_got, i_ref[0, :nv].cpu().numpy(), s_plain)
            check(all(h["label"] == labels[int(h["identifier"][3:])]
                      for h in hits), "closest: labels do not match ids")
            counts["closest-concepts"] += 1
        for _ in range(100):
            a, b = (int(x) for x in rng.integers(0, n, 2))
            st, body = _http_json(base, "/sim/go/transe",
                                  {"a": ids[a], "b": labels[b]})
            check(st == 200, f"sim: {body}")
            ua, ub = unit_rows(emb, norms, [a]), unit_rows(emb, norms, [b])
            want = float(np.einsum("ij,ij->i", ua, ub)[0])
            check(abs(body["score"] - want) <= 1e-6, "sim score off")
            sim_bits_exact += body["score"] == want
            counts["sim"] += 1
        for r in rng.integers(0, n, 50):
            st, body = _http_json(base, "/get-vector/go/transe",
                                  {"query": ids[int(r)]})
            check(st == 200 and body["vector"] == [float(x) for x in emb[r]],
                  f"get-vector {ids[int(r)]} differs from the table row")
            counts["get-vector"] += 1
        for off in range(0, 20 * 97, 97):
            st, body = _http_json(base, "/download/go/transe",
                                  {"offset": off, "limit": 13})
            check(st == 200 and [r[0] for r in body["rows"]]
                  == ids[off:off + 13] and all(
                      r[1] == [float(x) for x in emb[off + j]]
                      for j, r in enumerate(body["rows"])),
                  f"download page at {off} differs")
            counts["download"] += 1
        norm_labels = sorted({" ".join(x.lower().split()) for x in labels})
        for r in rng.integers(0, n, 50):
            prefix = labels[int(r)][:-4]
            st, body = _http_json(base, "/autocomplete/go/transe",
                                  {"prefix": prefix, "limit": 5})
            p = " ".join(prefix.lower().split())
            want = [x for x in norm_labels if x.startswith(p)][:5]
            check(st == 200 and [" ".join(c.lower().split())
                                 for c in body["completions"]] == want,
                  f"autocomplete {prefix!r}")
            counts["autocomplete"] += 1
        stats = gw.stats()
    finally:
        server.close()
        gw.close()
    torch.cuda.synchronize()
    launches = dict(ts.launches)
    check(sum(launches[x] for x in SMALL_ENTRY)
          > sum(after_session[x] for x in SMALL_ENTRY),
          "HTTP phase launched no small-k kernel")
    check(all(launches[x] > 0 for x in ("topk_score_keys", "topk_gather")),
          "k=2000 requests launched no large-k kernel")
    out = {"phase": "serve", "session": session, "http_requests": counts,
           "sim_bit_exact": sim_bits_exact,
           "stream_stats": dict(ops.stream_stats),
           "scheduler_batches": stats.scheduler["batches"],
           "launches": launches}
    emit(out)
    return out


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _host_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _device_ms(fn, iters: int = 10) -> dict:
    """Device time per call by kernel (or copy) name, from torch.profiler's
    CUPTI trace; empty when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us:
            m = re.search(r"(\w+_kernel)\b", evt.key)
            name = m.group(1) if m else evt.key[:48]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def bound_ms(Q: int, rows: int, k: int, k_run: int) -> tuple:
    """Least time for one top-k over ``rows`` table rows: each input read
    once (rows, norms, queries, exclusions, running list), each output
    written once; operations are the 2*Q*rows*D of the scores."""
    nbytes = (rows * D * 4 + rows * 4 + Q * D * 4 + Q * 4
              + Q * k_run * 8 + Q * k * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * Q * rows * D / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_numbers(store_tables, card: str) -> dict:
    import torch
    from repro_torch.kernels import ops, ref, topk_similarity as ts

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 2)
    rows_out = []
    slab = ops.STREAM_BLOCK_ROWS
    for n_rows, (table, norms) in store_tables.items():
        table_dev = torch.from_numpy(np.array(table)).to(dev)
        norms_dev = torch.from_numpy(np.array(norms)).to(dev)
        unit_dev = table_dev / norms_dev[:, None].clamp(min=1e-12)
        pinned = torch.empty((n_rows, D), dtype=torch.float32,
                             pin_memory=True)
        pinned.copy_(torch.from_numpy(np.array(table)))
        landing = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
        h2d_ms = _cuda_ms(lambda: landing.copy_(pinned, non_blocking=True))
        gather_ms = _host_ms(lambda: np.copyto(pinned.numpy(), table))
        del landing
        pool = ops.StagingPool()
        for Q in (1, 32, 64):
            rows = rng.choice(n_rows, size=Q, replace=False)
            q = unit_rows(table, norms, rows)
            excl = rows.astype(np.int32)
            q_dev = torch.from_numpy(q).to(dev)
            x_dev = torch.from_numpy(excl).to(dev)
            for k in (10, 2000):
                run_s, run_i = ts.topk_cosine_step(
                    q_dev, table_dev[:slab], norms_dev[:slab], x_dev, 0,
                    n_rows, k)
                blk, nb = table_dev[slab:2 * slab], norms_dev[slab:2 * slab]
                step = lambda: ts.topk_cosine_step(
                    q_dev, blk, nb, x_dev, slab, n_rows, k, run_s, run_i)
                plain_step = lambda: ref.stream_step_ref(
                    q_dev, blk, nb, slab, n_rows, x_dev, run_s, run_i, k)
                ublk = unit_dev[slab:2 * slab]
                lib_step = lambda: torch.topk(torch.matmul(q_dev, ublk.T), k)
                call = lambda: ops.topk_cosine(q_dev, table_dev, k,
                                               exclude_rows=excl,
                                               norms=norms_dev)
                plain_call = lambda: ref.stream_step_ref(
                    q_dev, table_dev, norms_dev, 0, n_rows, x_dev, None,
                    None, k)
                lib_call = lambda: torch.topk(torch.matmul(q_dev, unit_dev.T),
                                              k)
                stream = lambda: ops.topk_cosine(q, table, k,
                                                 exclude_rows=excl,
                                                 norms=norms, device=dev,
                                                 staging=pool)
                ours = {n: t for n, t in _device_ms(step).items()
                        if n.replace("_kernel", "") in _KERNEL_NAMES}
                busy = _device_ms(stream, iters=3)
                b_step, by_step = bound_ms(Q, slab, k, k)
                b_call, by_call = bound_ms(Q, n_rows, k, 0)
                rec = {
                    "N": n_rows, "Q": Q, "k": k,
                    "step_ms": _cuda_ms(step),
                    "step_plain_ms": _cuda_ms(plain_step),
                    "step_library_ms": _cuda_ms(lib_step),
                    "step_bound_ms": b_step, "step_bound_by": by_step,
                    "call_ms": _cuda_ms(call, iters=10),
                    "call_plain_ms": _cuda_ms(plain_call, iters=10),
                    "call_library_ms": _cuda_ms(lib_call, iters=10),
                    "call_bound_ms": b_call, "call_bound_by": by_call,
                    "step_device_ms": sum(ours.values()) if ours else None,
                    "step_device_by_kernel": ours,
                    "stream_call_ms": _host_ms(stream),
                    "stream_device_busy_ms": sum(busy.values()) if busy
                    else None,
                    "stream_slabs": -(-n_rows // slab),
                    "h2d_ms": h2d_ms, "host_gather_ms": gather_ms,
                    "card": card}
                emit({"numbers": rec})
                rows_out.append(rec)
        del table_dev, norms_dev, unit_dev, pinned
        torch.cuda.synchronize()
    return {"phase": "numbers", "rows": rows_out}


def kernels_line(kern: dict, serve_out: dict, numbers: dict) -> dict:
    """One entry per kernel path, at the shapes the main path gives it:
    a 8192-row slab of the 40k table with its running list, Q = 32 and
    k = 10 for the small path (the serve session's batches), Q = 1 and
    k = 2000 for the large one (the k = 2000 HTTP requests)."""
    launches = serve_out["launches"]
    by = {(r["N"], r["Q"], r["k"]): r for r in numbers["rows"]}
    out = []
    for name, entries, key, err in (
            ("topk_cosine_step (k <= 64: select + merge)", SMALL_ENTRY,
             (GO_ROWS, 32, 10), kern["max_abs_err_small"]),
            ("topk_cosine_step (k > 64: keys + bitonic sort + gather)",
             LARGE_ENTRY, (GO_ROWS, 1, 2000), kern["max_abs_err_large"])):
        r = by[key]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": sum(launches[e] for e in entries),
            "launches_by_entry": {e: launches[e] for e in entries},
            "max_abs_err": err, "ms": r["step_ms"],
            "device_ms": r["step_device_ms"],
            "plain_ms": r["step_plain_ms"], "bound_ms": r["step_bound_ms"],
            "bound_by": r["step_bound_by"],
            "library_ms": r["step_library_ms"]})
    return {"kernels": out}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,serve,numbers")
    ap.add_argument("--out", default=None, help="also write results here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}; run it from the "
              f"repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[chip_smoke] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.registry import EmbeddingRegistry

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="biokg-smoke-") as tmp:
        store_tables = {}
        served = None
        if phases & {"kernels", "serve", "numbers"}:
            reg = EmbeddingRegistry(tmp)
            for i, version in enumerate(("2025-01", "2025-02")):
                ids, labels, emb = go_table(GO_ROWS, SEED + i)
                reg.publish("go", version, "transe", ids, labels, emb,
                            ontology_checksum=f"seed-{SEED + i}",
                            hyperparameters={"dim": D, "seed": SEED + i},
                            generated_at="2025-01-01T00:00:00+00:00")
                reg.seal("go", version)
            served = {"ids": ids, "labels": labels, "emb": emb}
            ids_s, labels_s, emb_s = go_table(SCALE_ROWS, SEED + 7)
            reg.publish("go-scale", "2025-01", "transe", ids_s, labels_s,
                        emb_s, ontology_checksum=f"seed-{SEED + 7}",
                        hyperparameters={"dim": D, "seed": SEED + 7},
                        generated_at="2025-01-01T00:00:00+00:00")
            del emb_s
            for ont, n_rows in (("go", GO_ROWS), ("go-scale", SCALE_ROWS)):
                table, norms, _ = reg.store.open_table(
                    ont, reg.store.latest_version(ont), "transe")
                store_tables[n_rows] = (table, norms)
        if "build" in phases:
            RESULTS["phases"]["build"] = phase_build()
        if "kernels" in phases:
            RESULTS["phases"]["kernels"] = phase_kernels(store_tables)
            torch.cuda.synchronize()
        if "serve" in phases:
            RESULTS["phases"]["serve"] = phase_serve(tmp, served)
            torch.cuda.synchronize()
        if "numbers" in phases:
            RESULTS["phases"]["numbers"] = phase_numbers(store_tables, card)
            torch.cuda.synchronize()
        store_tables.clear()
    RESULTS["seconds"] = time.perf_counter() - t_start
    RESULTS["card"] = card
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))
    print(card)
    if {"kernels", "serve", "numbers"} <= phases:
        print(json.dumps(kernels_line(RESULTS["phases"]["kernels"],
                                      RESULTS["phases"]["serve"],
                                      RESULTS["phases"]["numbers"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
