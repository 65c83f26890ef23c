"""The port's pre-forked multi-process serving, on the CPU.

Holds ``repro_torch.api.workers`` to the contracts of
``tests/test_workers.py``: one real pool (``python -m
repro_torch.api.workers``, 2 workers on ``--device cpu``, started from a
fresh interpreter that runs no torch op before it forks) driven over real
sockets for wire parity with the in-process gateway, ``/stats`` merged
across workers, publish visible across processes, and SIGKILL restart
under load.  Besides: the pool's parent never initialises CUDA nor
resolves a device (a CUDA context must not cross a fork),
``merge_stats_wires`` equals the reference's on the same wires, and
``launch.serve --http --workers`` serves through the pool.  Every test
runs under its own time limit, so a hung pool fails its test and does not
eat the suite's clock.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
N, D = 48, 16
#: seconds each test may take (SIGALRM fails it past that)
TEST_LIMIT_S = 90


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


def _publish(root, version, seed):
    from repro_torch.core.registry import EmbeddingRegistry
    rng = np.random.default_rng(seed)
    registry = EmbeddingRegistry(root)
    ids = [f"GO:{i:07d}" for i in range(N)]
    labels = [f"go term {i}" for i in range(N)]
    emb = rng.standard_normal((N, D)).astype(np.float32)
    registry.publish("go", version, "transe", ids, labels, emb,
                     ontology_checksum=f"ck-{version}",
                     hyperparameters={"dim": D})
    registry.seal("go", version)
    return ids, emb


def _get(port, path, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stats(port):
    status, body = _get(port, "/stats")
    assert status == 200
    return json.loads(body)


def _readline(proc, timeout_s):
    """The next stdout line of ``proc``, or '' after ``timeout_s``."""
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout_s)
    return out[0].strip() if out else ""


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wreg"))
    ids, emb = _publish(root, "2024-01", seed=1)
    state = str(tmp_path_factory.mktemp("wstate"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.api.workers", "--registry", root,
         "--workers", "2", "--device", "cpu", "--watch-interval-ms", "100",
         "--stats-interval-ms", "200", "--state-dir", state],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO))
    line = _readline(proc, 90)
    if not line.startswith("READY"):
        proc.kill()
        raise RuntimeError(f"pool failed to start: {line!r}\n"
                           f"{proc.communicate()[1]}")
    port = int(line.split("port=")[1].split()[0])
    yield {"proc": proc, "port": port, "root": root, "ids": ids, "emb": emb,
           "state": state}
    _stop(proc)


def test_wire_parity_with_inprocess_gateway(pool):
    """Bodies over the pool's socket are byte-identical to the wire dicts
    ``Gateway.handle`` produces in-process over the same registry."""
    from repro_torch.api import Gateway
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import ServingEngine
    ids = pool["ids"]
    paths = [f"/get-vector/go/transe?query={ids[0]}",
             f"/sim/go/transe?a={ids[1]}&b={ids[2]}",
             f"/closest-concepts/go/transe?query={ids[3]}&k=5",
             "/download/go/transe?offset=0&limit=4",
             "/autocomplete/go/transe?prefix=go%20term%201&limit=5",
             "/versions/go"]
    gw = Gateway(ServingEngine(EmbeddingRegistry(pool["root"]),
                               device="cpu"))
    try:
        for path in paths:
            status, body = _get(pool["port"], path)
            assert status == 200, (path, body[:200])
            route, _, query = path.partition("?")
            payload = {}
            for k, v in urllib.parse.parse_qsl(query):
                payload[k] = int(v) if v.isdigit() else v
            expect = json.dumps(gw.handle(route, payload)).encode()
            assert body == expect, path
    finally:
        gw.close()


def test_stats_merged_across_workers(pool):
    """/stats answered by either worker reports the whole pool: a
    ``workers`` block with both pids and counters summed from the
    per-worker state dumps; transport-level 304s are pool-visible too."""
    ids = pool["ids"]
    for i in range(12):
        status, _ = _get(pool["port"],
                         f"/get-vector/go/transe?query={ids[i % N]}")
        assert status == 200
    deadline = time.time() + 15
    while time.time() < deadline:
        st = _stats(pool["port"])
        w = st.get("workers", {})
        if w.get("count") == 2 and st["gateway"]["requests"] >= 12:
            break
        time.sleep(0.2)
    assert w["count"] == 2
    assert len(w["pids"]) == 2
    assert st["type"] == "stats_response"
    assert st["gateway"]["requests"] >= 12      # summed, not per-worker
    assert "latency" in st and "scheduler" in st

    conn = http.client.HTTPConnection("127.0.0.1", pool["port"], timeout=30)
    try:
        conn.request("GET", "/download/go/transe?limit=3")
        resp = conn.getresponse()
        resp.read()
        etag = resp.getheader("ETag")
        conn.request("GET", "/download/go/transe?limit=3",
                     headers={"If-None-Match": etag})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 304
    finally:
        conn.close()
    deadline = time.time() + 15
    nm, lat = 0, None
    while time.time() < deadline:
        http_block = _stats(pool["port"])["workers"].get("http", {})
        nm = http_block.get("not_modified", 0)
        lat = (http_block.get("latency_ms") or {}).get("not_modified")
        if nm >= 1 and lat and lat.get("count", 0) >= 1:
            break
        time.sleep(0.2)
    assert nm >= 1
    assert lat["count"] >= 1 and lat["p50_ms"] >= 0


def test_worker_state_dumps_name_device_and_launches(pool):
    """Each worker dumps its device and its top-k launches (the CPU pool
    runs the plain version, so it launches nothing)."""
    from repro_torch.api.workers import read_worker_states
    states = read_worker_states(pool["state"])
    assert len(states) >= 2
    for s in states:
        assert s["device"] == "cpu"
        assert set(s["kernel_launches"]) >= {"topk_score_select",
                                             "topk_merge_lists"}
        assert sum(s["kernel_launches"].values()) == 0


def test_publish_visible_across_processes(pool):
    """A publish+seal from THIS process becomes servable in the pool's
    workers without any signal besides the store itself."""
    ids, emb2 = _publish(pool["root"], "2024-02", seed=2)
    deadline = time.time() + 20
    latest = None
    while time.time() < deadline:
        _, body = _get(pool["port"], "/versions/go")
        latest = json.loads(body).get("latest")
        if latest == "2024-02":
            break
        time.sleep(0.1)
    assert latest == "2024-02"
    _, body = _get(pool["port"], f"/get-vector/go/transe?query={ids[5]}")
    got = np.asarray(json.loads(body)["vector"], dtype=np.float32)
    np.testing.assert_array_equal(got, emb2[5])


def test_sigkill_worker_is_restarted_under_load(pool):
    """SIGKILL one worker mid-traffic: the supervisor respawns it, the
    pool keeps answering (at most one retryable client error), and
    /stats shows the restart."""
    ids = pool["ids"]
    victim = _stats(pool["port"])["workers"]["pids"][0]
    os.kill(victim, signal.SIGKILL)
    errors = 0
    for i in range(40):
        try:
            status, _ = _get(pool["port"],
                             f"/sim/go/transe?a={ids[i % N]}&b={ids[0]}",
                             timeout=10)
            if status != 200:
                errors += 1
        except OSError:
            errors += 1
        time.sleep(0.05)
    assert errors <= 1, f"{errors} client errors after SIGKILL"
    deadline = time.time() + 20
    while time.time() < deadline:
        w = _stats(pool["port"])["workers"]
        if w["count"] == 2 and w["restarts"] >= 1 \
                and victim not in w["pids"]:
            break
        time.sleep(0.2)
    assert w["count"] == 2
    assert w["restarts"] >= 1
    assert victim not in w["pids"]


_PARENT_SCRIPT = r"""
import json, sys, time, urllib.request
import torch
import repro_torch.device as dev_mod
resolved, probed = [], []
real_resolve, real_available = dev_mod.resolve_device, torch.cuda.is_available
def resolve(*a, **k):
    resolved.append(repr(a))
    return real_resolve(*a, **k)
def available():
    probed.append(1)
    return real_available()
dev_mod.resolve_device = resolve
torch.cuda.is_available = available
from repro_torch.api.workers import WorkerPool
pool = WorkerPool(sys.argv[1], workers=2, device="cpu",
                  watch_interval_s=0.1, stats_interval_s=0.2)
pool.start()
try:
    pool.wait_ready(60)
    ok = []
    for i in range(6):
        with urllib.request.urlopen(
                pool.url + "/closest-concepts/go/transe?query=GO:%07d&k=3"
                % i, timeout=30) as r:
            ok.append(r.status)
    victim = pool.kill_one()
    deadline = time.time() + 30
    while time.time() < deadline and (pool.restarts < 1 or victim in
                                      pool.pids() or len(pool.pids()) != 2):
        time.sleep(0.05)
    pool.wait_ready(30)
    print(json.dumps({
        "cuda_initialized": torch.cuda.is_initialized(),
        "resolve_calls_in_parent": resolved,
        "availability_probes_in_parent": len(probed),
        "statuses": ok, "restarts": pool.restarts,
        "victim_gone": victim not in pool.pids(),
        "workers": len(pool.pids()),
        "supervisor_state": json.loads(
            (pool.state_dir / "supervisor.json").read_text())}))
finally:
    pool.stop()
"""


def test_pool_parent_never_touches_cuda_and_kill_one_restarts(tmp_path):
    """In a fresh interpreter: after ``WorkerPool(..., device="cpu")``
    starts, serves and survives ``kill_one()``, the parent has not
    initialised CUDA, never resolved a device and never asked whether
    CUDA is available (each of which would create driver state the
    forked workers could not use on a card)."""
    _publish(str(tmp_path / "reg"), "2024-01", seed=3)
    out = subprocess.run(
        [sys.executable, "-c", _PARENT_SCRIPT, str(tmp_path / "reg")],
        capture_output=True, text=True, env=_env(), cwd=str(REPO),
        timeout=TEST_LIMIT_S - 10)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["cuda_initialized"] is False
    assert res["resolve_calls_in_parent"] == []
    assert res["availability_probes_in_parent"] == 0
    assert res["statuses"] == [200] * 6
    assert res["restarts"] >= 1 and res["victim_gone"]
    assert res["workers"] == 2
    sup = res["supervisor_state"]
    assert sup["cuda_initialized"] is False and sup["device"] == "cpu"


def test_pool_takes_its_device_as_a_string(tmp_path):
    from repro_torch.api.workers import WorkerPool
    import torch
    with pytest.raises(ValueError, match="string"):
        WorkerPool(tmp_path, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="workers"):
        WorkerPool(tmp_path, workers=0, device="cpu")


# ------------------------- merge_stats_wires --------------------------- #
def _hand_wire(seed, routes):
    from repro_torch.core.metrics import LatencyHistogram
    rng = np.random.default_rng(seed)

    def hist(n):
        h = LatencyHistogram()
        for s in rng.exponential(0.004, n):
            h.observe(float(s))
        return h.snapshot()

    return {
        "type": "stats_response",
        "scheduler": {"batches": int(rng.integers(1, 50)),
                      "padded_queries": int(rng.integers(0, 9)),
                      "flush_loop": True, "latency_ms": hist(30)},
        "cache": {"hits": int(rng.integers(0, 99)), "capacity": 8,
                  "mode": "lru", "by_ontology": {"go": int(seed)}},
        "gateway": {"requests": int(rng.integers(1, 500)),
                    "errors": {"BAD_REQUEST": int(seed % 3)}},
        "latency": {r: hist(int(rng.integers(1, 40))) for r in routes},
    }


@pytest.mark.parametrize("n_wires", [0, 1, 3])
def test_merge_stats_wires_equals_the_reference(n_wires):
    """Counters add, bools and strings keep the first value, histograms
    merge by buckets and routes union: the reference's merge, on the same
    hand-made wires."""
    from repro.api.workers import merge_stats_wires as jmerge
    from repro_torch.api.workers import merge_stats_wires
    route_sets = [["closest-concepts", "sim"], ["sim"],
                  ["download", "get-vector", "sim"]]
    wires = [_hand_wire(i + 1, route_sets[i]) for i in range(n_wires)]
    got = merge_stats_wires(json.loads(json.dumps(wires)))
    assert got == jmerge(json.loads(json.dumps(wires)))
    if n_wires == 3:
        assert got["gateway"]["requests"] == sum(
            w["gateway"]["requests"] for w in wires)
        assert got["cache"]["capacity"] == 24
        assert got["scheduler"]["flush_loop"] is True
        assert got["latency"]["sim"]["count"] == sum(
            w["latency"]["sim"]["count"] for w in wires)
        assert sorted(got["latency"]) == ["closest-concepts", "download",
                                          "get-vector", "sim"]


# --------------------------- launch.serve ------------------------------ #
def test_launch_serve_http_workers_serves_through_the_pool(tmp_path):
    """``python -m repro_torch.launch.serve --http 0 --workers 2`` over a
    published registry: both workers answer one merged /stats, and
    SIGTERM takes the pool down."""
    ids, emb = _publish(str(tmp_path / "reg"), "2024-01", seed=4)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--registry",
         str(tmp_path / "reg"), "--http", "0", "--workers", "2",
         "--device", "cpu", "--state-dir", str(tmp_path / "state")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO))
    try:
        line = _readline(proc, 60)
        assert "HTTP service on http://" in line and "2 workers" in line, \
            line
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        _, body = _get(port, f"/get-vector/go/transe?query={ids[7]}")
        np.testing.assert_array_equal(
            np.asarray(json.loads(body)["vector"], np.float32), emb[7])
        deadline = time.time() + 15
        while time.time() < deadline:
            w = _stats(port)["workers"]
            if w["count"] == 2:
                break
            time.sleep(0.2)
        assert w["count"] == 2
    finally:
        _stop(proc)
    assert proc.returncode == 0


def test_launch_serve_trains_a_missing_registry_first(tmp_path, monkeypatch):
    """An empty registry is trained before serving, as the reference's
    launcher does it: the workload's models at 150 steps and 800 terms,
    in a subprocess when workers will fork (the pool's parent resolves no
    device), in process otherwise."""
    from repro_torch.launch import serve, train
    reg = str(tmp_path / "empty")
    seen = {}

    def fake_train(ontology, registry, **kw):
        seen["train"] = (ontology, registry, kw)
        _publish(registry, "2024-01", seed=5)

    def fake_run(cmd, env, check):
        seen["subprocess"] = cmd[-1]
        _publish(reg, "2024-01", seed=5)

    monkeypatch.setattr(train, "train_kge", fake_train)
    monkeypatch.setattr(serve.subprocess, "run", fake_run)
    monkeypatch.setattr(serve, "_serve_pool",
                        lambda args: seen.setdefault("pool", args.workers))
    monkeypatch.setattr(serve, "resolve_device", lambda d: pytest.fail(
        "the pool's parent resolved a device"))
    serve.main(["--registry", reg, "--http", "0", "--workers", "2",
                "--device", "cpu"])
    assert "train_kge('go', " in seen["subprocess"]
    assert "steps=150, n_terms=800" in seen["subprocess"]
    assert seen["pool"] == 2 and "train" not in seen

    monkeypatch.undo()
    monkeypatch.setattr(train, "train_kge", fake_train)
    other = str(tmp_path / "other")
    out = serve.main(["--registry", other, "--device", "cpu",
                      "--requests", "8", "--threads", "2", "--batch", "4"])
    assert seen["train"][:2] == ("go", other)
    assert seen["train"][2]["steps"] == 150
    assert seen["train"][2]["n_terms"] == 800
    assert out["classes"] == N


def test_launch_serve_no_train_if_missing_refuses_an_empty_registry(
        tmp_path, monkeypatch):
    """``--no-train-if-missing`` turns the training off: an empty
    registry is an error naming the store, and nothing is trained.  The
    default registry lies under the process's temporary directory."""
    import tempfile
    from repro_torch.launch import serve, train
    monkeypatch.setattr(train, "train_kge", lambda *a, **kw: pytest.fail(
        "trained with --no-train-if-missing"))
    reg = str(tmp_path / "empty")
    with pytest.raises(SystemExit, match="no published 'go' snapshots"):
        serve.main(["--registry", reg, "--device", "cpu",
                    "--no-train-if-missing"])
    default = serve._parser().parse_args([])
    assert default.registry == os.path.join(tempfile.gettempdir(),
                                            "biokgvec2go")
    assert default.train_if_missing is True
