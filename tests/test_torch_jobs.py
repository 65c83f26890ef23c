"""The port's batch-analytics jobs against the JAX package's, on the CPU.

One seeded store (two synthetic GO releases, the paper's six models with
their params and parsed graphs) is copied twice, one copy per package, so
the ``eval.json`` caches that ``compare`` writes do not cross.  The same
``knn-join`` / ``drift`` / ``compare`` jobs go through
``repro.api.gateway.Gateway`` (JAX, CPU) and the port's ``Gateway``
(``device="cpu"``, the top-k kernel's plain version).  Held:

* join ids exact outside runs of reference scores closer than 1e-6, where
  only the sets must match; scores within 1e-6;
* drift Jaccard equal, entities whose k-th and (k+1)-th reference scores
  lie within 1e-6 in either release excepted and counted;
* compare metrics within 1e-5, for the "kge" and the "cosine" method;
* status and result wire bodies equal apart from ``job_id``,
  ``owner_pid``, ``submitted_at``, ``wall_s`` and ``compute_s`` (and the
  join's scores, held as above); ``job_etag`` equal to the reference's.

Then the lifecycle cases of ``tests/test_jobs.py`` against the port:
validation taxonomy counted once, cancelled -> ``JOB_CANCELLED``, queue
overflow fast-reject, a poll storm with monotone progress, the HTTP
round trip (ETag/304, stream, taxonomy), the async job surface, and the
orphan rule in a real 2-worker pool on ``--device cpu``.  Each test runs
under its own time limit.  One ``cuda`` test holds the join to serial
``top_k_rows`` bit for bit on the card.
"""
import asyncio
import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Gateway as JaxGateway
from repro.api.gateway import job_etag as jax_job_etag
from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro.core.serving import ServingEngine as JaxEngine
from repro.ontology.synthetic import GO_SPEC, evolve, generate
from repro_torch.api import ApiError, AsyncGateway, Gateway, serve_http
from repro_torch.api.gateway import job_etag
from repro_torch.core.registry import EmbeddingRegistry
from repro_torch.core.serving import ServingEngine
from repro_torch.kernels import _build
from repro_torch.kge.base import make_model as torch_make_model

REPO = Path(__file__).resolve().parents[1]
TEST_LIMIT_S = 120
MODELS = ("transe", "transr", "distmult", "hole", "boxe", "rdf2vec")
DIM = 16
N_TERMS = 120
V1, V2 = "2024-01", "2024-02"
TIE_TOL = 1e-6        # reference scores this close may order ids freely
SCORE_TOL = 1e-6      # join scores, port against reference
METRIC_TOL = 1e-5     # compare metrics, port against reference
#: status/result fields that differ between two runs of one job
VOLATILE = {"job_id", "owner_pid", "submitted_at", "wall_s", "compute_s"}


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# ------------------------------ the store ------------------------------ #
def _publish_release(reg, kg, version, seed):
    """Every model of MODELS with seeded random params.  The triple models
    store an entity vocab equal to the graph's (so compare scores them
    exactly); RDF2vec stores walk tokens (so compare falls back to
    cosine over the served table, as the reference's does)."""
    n, r = len(kg.entities), len(kg.relations)
    for mi, name in enumerate(MODELS):
        rng = np.random.default_rng(seed * 100 + mi)
        shapes = torch_make_model(name, n, r, dim=DIM).param_shapes()
        params = {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()}
        ents = list(kg.entities)
        vocab = {"entity": ents if name != "rdf2vec"
                 else [f"tok:{e}" for e in ents],
                 "relation": list(kg.relations)}
        reg.publish("go", version, name, ents,
                    [kg.terms[e].label if e in kg.terms else e for e in ents],
                    params["entity"], ontology_checksum=f"ck-{version}",
                    hyperparameters={"dim": DIM}, params=params,
                    params_vocab=vocab)
    reg.store.save_graph("go", version, kg)
    reg.seal("go", version)


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    root = tmp_path_factory.mktemp("jobs_store")
    reg = JaxRegistry(root)
    kg1 = generate(GO_SPEC, seed=0, n_terms=N_TERMS)
    kg2 = evolve(kg1, GO_SPEC, seed=1, add_frac=0.05, obsolete_frac=0.02,
                 rewire_frac=0.05)
    _publish_release(reg, kg1, V1, 1)
    _publish_release(reg, kg2, V2, 2)
    return root


@pytest.fixture()
def pair(template, tmp_path):
    """(reference gateway, port gateway), each over its own copy."""
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(template, ref_root)
    shutil.copytree(template, port_root)
    ref = JaxGateway(JaxEngine(JaxRegistry(ref_root), cache_capacity=8))
    port = Gateway(ServingEngine(EmbeddingRegistry(port_root),
                                 cache_capacity=8, device="cpu"))
    yield ref, port
    ref.close()
    port.close()


def _run(gw, kind, **kw):
    sub = gw.submit_job(kind, "go", **kw)
    st = gw.job_wait(sub.job_id, timeout=60)
    assert st.state == "DONE", (kind, st.error)
    return st, gw.job_result(sub.job_id, limit=10_000)


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _ids_agree(a, b, s_ref):
    """ids equal position by position, except inside runs of reference
    scores closer than TIE_TOL, where only the sets must match (a run cut
    by the end of the row may hold different members).  Returns the
    number of runs the set rule relaxed."""
    a, b, s_ref = np.asarray(a), np.asarray(b), np.asarray(s_ref)
    if np.array_equal(a, b):
        return 0
    n = len(a)
    brk = np.ones(n, bool)
    brk[1:] = (s_ref[:-1] - s_ref[1:]) >= TIE_TOL
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], n)
    run_of = np.cumsum(brk) - 1
    relaxed = 0
    for rid in np.unique(run_of[a != b]):
        lo, hi = starts[rid], ends[rid]
        if hi < n:
            assert sorted(a[lo:hi]) == sorted(b[lo:hi]), (
                f"ids differ outside a near-tie run at [{lo}, {hi})")
        relaxed += 1
    return relaxed


# --------------------------- parity with JAX --------------------------- #
@pytest.mark.parametrize("model,k,version", [
    ("transe", 10, None), ("distmult", 5, V1), ("rdf2vec", 3, None)])
def test_knn_join_matches_reference(pair, model, k, version):
    ref, port = pair
    classes = ref.download("go", model, version=version,
                           limit=10_000).rows
    classes = [r[0] for r in classes]
    st_r, pg_r = _run(ref, "knn-join", model=model, classes=classes, k=k,
                      version=version)
    st_p, pg_p = _run(port, "knn-join", model=model, classes=classes, k=k,
                      version=version)
    assert _strip(st_p.__dict__) == _strip(st_r.__dict__)
    assert len(pg_p.rows) == len(pg_r.rows) == len(classes)
    relaxed = 0
    for (ip, hp), (ir, hr) in zip(pg_p.rows, pg_r.rows):
        assert ip == ir
        assert len(hp) == len(hr) == k
        relaxed += _ids_agree([h[0] for h in hp], [h[0] for h in hr],
                              [h[1] for h in hr])
        np.testing.assert_allclose([h[1] for h in hp], [h[1] for h in hr],
                                   rtol=0, atol=SCORE_TOL)
    assert relaxed <= len(classes) // 20, relaxed


@pytest.mark.parametrize("model", ["transe", "distmult"])
def test_drift_matches_reference(pair, model):
    ref, port = pair
    k = 5
    st_r, pg_r = _run(ref, "drift", model=model, k=k)
    st_p, pg_p = _run(port, "drift", model=model, k=k)
    assert (st_p.version, st_p.version_b) == (V1, V2)
    assert st_p.summary["graph_delta"] == st_r.summary["graph_delta"]
    idx_a = ref.engine._index("go", model, V1)
    idx_b = ref.engine._index("go", model, V2)

    def near_tie(idx, ident):
        s = [c.score for c in idx.top_k([ident], k=k + 1)[0]]
        return len(s) > k and s[k - 1] - s[k] < TIE_TOL

    excepted = []
    want = dict(pg_r.rows)
    assert [r[0] for r in pg_p.rows] == [r[0] for r in pg_r.rows]
    for ident, jac in pg_p.rows:
        if jac != want[ident]:
            assert near_tie(idx_a, ident) or near_tie(idx_b, ident), ident
            excepted.append(ident)
    assert len(excepted) <= len(want) // 20, excepted
    if not excepted:
        assert _strip(st_p.__dict__) == _strip(st_r.__dict__)
        assert _strip(pg_p.__dict__) == _strip(pg_r.__dict__)


def test_compare_matches_reference_and_caches(pair):
    ref, port = pair
    st_r, pg_r = _run(ref, "compare", models=list(MODELS), sample=60)
    st_p, pg_p = _run(port, "compare", models=list(MODELS), sample=60)
    got, want = dict(pg_p.rows), dict(pg_r.rows)
    assert list(got) == list(want) == list(MODELS)
    for m in MODELS:
        assert got[m]["method"] == want[m]["method"] == (
            "cosine" if m == "rdf2vec" else "kge"), m
        assert got[m]["sample"] == want[m]["sample"] == 60
        assert got[m]["cached"] is False
        for key in ("mrr", "mean_rank", "hits@1", "hits@3", "hits@10"):
            assert got[m][key] == pytest.approx(want[m][key], rel=METRIC_TOL,
                                                abs=METRIC_TOL), (m, key)
    assert st_p.summary == st_r.summary
    st2, pg2 = _run(port, "compare", models=list(MODELS), sample=60)
    assert all(row[1]["cached"] is True for row in pg2.rows)
    assert st2.summary["cached"] == len(MODELS)
    assert st2.summary["computed"] == 0


def test_compare_metrics_equal_port_rank_based_eval(pair):
    """A "kge" row is the port's own filtered ranking on the same seeded
    permutation of the release's triples."""
    from repro_torch.kge.base import params_from_numpy
    from repro_torch.kge.eval import rank_based_eval
    _, port = pair
    _, pg = _run(port, "compare", models=["transe", "distmult"], sample=40)
    store = port.engine.registry.store
    kg = store.load_graph("go", V2)
    perm = np.random.default_rng(0).permutation(len(kg.triples))
    trip = np.asarray(kg.triples)
    for name, metrics in pg.rows:
        params, _ = store.load_params("go", V2, name)
        model = torch_make_model(name, kg.num_entities, kg.num_relations,
                                 dim=DIM)
        want = rank_based_eval(model, params_from_numpy(model, params, "cpu"),
                               trip[perm[:40]], trip, batch_size=64)
        for key, v in want.items():
            assert metrics[key] == pytest.approx(v, abs=1e-12), (name, key)


@pytest.mark.parametrize("exc,state,method", [
    (RuntimeError("CUDA error: an illegal memory access"), "FAILED", None),
    (ValueError("shape mismatch"), "DONE", "cosine")])
def test_compare_falls_back_to_cosine_only_on_lookup_faults(
        pair, monkeypatch, exc, state, method):
    """The "kge" method falls back to cosine ranking on KeyError,
    ValueError or TypeError only: a device fault fails the job."""
    from repro_torch.kge.transe import TransE

    def broken(self, params, h, r):
        raise exc

    monkeypatch.setattr(TransE, "score_all_tails", broken)
    _, port = pair
    sub = port.submit_job("compare", "go", models=["transe"], sample=20)
    st = port.job_wait(sub.job_id, timeout=60)
    assert st.state == state, st.error
    if method is None:
        assert "RuntimeError" in st.error and "CUDA error" in st.error
    else:
        assert port.job_result(sub.job_id).rows[0][1]["method"] == method


def test_wire_bodies_equal_reference(pair):
    """Status, list and result wire bodies through ``Gateway.handle``."""
    ref, port = pair
    payload = {"kind": "drift", "ontology": "go", "model": "transe", "k": 3,
               "classes": ["GO:0000004", "GO:0000010", "GO:0000030"]}
    wires = []
    for gw in (ref, port):
        sub = gw.handle("/jobs/submit", payload)
        assert sub["type"] == "job_status_response" and sub["state"] in (
            "PENDING", "RUNNING", "DONE")
        gw.job_wait(sub["job_id"], timeout=60)
        jid = sub["job_id"]
        wires.append([gw.handle(f"/jobs/{jid}"),
                      gw.handle(f"/jobs/{jid}/result", {"limit": 2}),
                      gw.handle(f"/jobs/{jid}/result", {"offset": 2}),
                      gw.handle("/jobs"),
                      gw.handle("/jobs/j0-404"),
                      gw.handle(f"/jobs/{jid}/cancel"),
                      gw.handle("/jobs/submit", {"kind": "nope",
                                                 "ontology": "go"}),
                      gw.handle("/jobs/submit", {"kind": "drift",
                                                 "ontology": "go",
                                                 "model": "transe",
                                                 "version": V2})])
    ref_w, port_w = wires
    for a, b in zip(port_w, ref_w):
        assert json.dumps(_strip(a), sort_keys=True) == \
            json.dumps(_strip(b), sort_keys=True)
    # the pages' ETags carry the job id, so they differ exactly there
    jid_p, jid_r = port_w[0]["job_id"], ref_w[0]["job_id"]
    assert port_w[1]["etag"] == job_etag(jid_p, 0, 2)
    assert ref_w[1]["etag"] == jax_job_etag(jid_r, 0, 2)
    assert port.stats().gateway["jobs"] == ref.stats().gateway["jobs"]


@pytest.mark.parametrize("args", [("j1-1", 0, 1000), ("j42-7", 5, 10, 20),
                                  ("j9-3", 2000, 1000, None)])
def test_job_etag_equals_reference(args):
    assert job_etag(*args) == jax_job_etag(*args)


# ------------------------- lifecycle (port only) ----------------------- #
N, D = 40, 12


def _publish(registry, version, seed, n=N):
    rng = np.random.default_rng(seed)
    ids = [f"GO:{i:07d}" for i in range(n)]
    registry.publish("go", version, "transe", ids,
                     [f"go term {i}" for i in range(n)],
                     rng.standard_normal((n, D)).astype(np.float32),
                     ontology_checksum=f"ck-{version}-{seed}",
                     hyperparameters={"dim": D})
    return ids


@pytest.fixture()
def registry(tmp_path):
    return EmbeddingRegistry(tmp_path / "registry")


@pytest.fixture()
def gw(registry):
    ids = _publish(registry, "2024-01", seed=1)
    _publish(registry, "2024-02", seed=2)
    gateway = Gateway(ServingEngine(registry, cache_capacity=4,
                                    device="cpu"))
    yield gateway, ids
    gateway.close()


def _slow_gw(registry, **kw):
    """A gateway whose jobs crawl: tiny slabs and a long inter-slab yield
    make RUNNING observable and give cancels and storms slabs to land in."""
    kw.setdefault("jobs_slab", 4)
    kw.setdefault("jobs_yield_s", 0.03)
    return Gateway(ServingEngine(registry, cache_capacity=4, device="cpu"),
                   **kw)


def test_compare_without_stored_graph_reports_skip(gw):
    gateway, _ = gw
    st, page = _run(gateway, "compare")
    assert [r[0] for r in page.rows] == ["transe"]
    assert page.rows[0][1] is None
    assert st.summary["skipped"] == 1 and "note" in st.summary


def test_submit_validation_and_taxonomy_counted_once(gw):
    gateway, ids = gw
    cases = [(dict(kind="frobnicate"), "BAD_REQUEST"),
             (dict(kind="knn-join", model="transe", classes=[]),
              "BAD_REQUEST"),
             (dict(kind="knn-join", model="nope", classes=ids[:2]),
              "UNKNOWN_MODEL"),
             (dict(kind="drift", model="transe", version_b="2024-01"),
              "BAD_REQUEST"),
             (dict(kind="compare", version="1999-01"), "UNKNOWN_VERSION")]
    for kw, code in cases:
        with pytest.raises(ApiError) as e:
            gateway.submit_job(ontology="go", **kw)
        assert e.value.code == code, kw
    # unknown classes fail the job (resolution happens on the executor),
    # with the missing list in the error
    sub = gateway.submit_job("knn-join", "go", model="transe",
                             classes=["GO:9999999"])
    st = gateway.job_wait(sub.job_id, timeout=30)
    assert st.state == "FAILED" and "UNKNOWN_CLASS" in st.error
    before = dict(gateway.stats().gateway["by_code"])
    wire = gateway.handle("jobs/j0-404")
    assert wire["code"] == "JOB_NOT_FOUND" and wire["status"] == 404
    done = gateway.submit_job("knn-join", "go", model="transe",
                              classes=ids[:3], k=3)
    gateway.job_wait(done.job_id, timeout=30)
    wire = gateway.handle(f"jobs/{done.job_id}/cancel")
    assert wire["code"] == "BAD_REQUEST" and wire["status"] == 400
    after = gateway.stats().gateway["by_code"]
    assert after["JOB_NOT_FOUND"] == before.get("JOB_NOT_FOUND", 0) + 1
    assert after["BAD_REQUEST"] == before.get("BAD_REQUEST", 0) + 1


def test_result_of_cancelled_job_is_job_cancelled(registry):
    ids = _publish(registry, "2024-01", seed=1)
    gateway = _slow_gw(registry)
    try:
        sub = gateway.submit_job("knn-join", "go", model="transe",
                                 classes=ids, k=3)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = gateway.job_status(sub.job_id)
            if st.state == "RUNNING" and st.progress > 0:
                break
            time.sleep(0.002)
        else:
            pytest.fail("job never observed RUNNING")
        gateway.job_cancel(sub.job_id)
        st = gateway.job_wait(sub.job_id, timeout=30)
        assert st.state == "CANCELLED" and 0 < st.progress < 1.0
        with pytest.raises(ApiError) as e:
            gateway.job_result(sub.job_id)
        assert e.value.code == "JOB_CANCELLED" and e.value.status == 409
    finally:
        gateway.close()


def test_queue_overflow_fast_rejects(registry):
    ids = _publish(registry, "2024-01", seed=1)
    gateway = _slow_gw(registry, max_jobs_queued=1)
    try:
        first = gateway.submit_job("knn-join", "go", model="transe",
                                   classes=ids, k=3)
        deadline = time.monotonic() + 30
        while gateway.job_status(first.job_id).state == "PENDING":
            assert time.monotonic() < deadline
            time.sleep(0.002)
        gateway.submit_job("knn-join", "go", model="transe",
                           classes=ids[:4], k=3)
        t0 = time.perf_counter()
        with pytest.raises(ApiError) as e:
            gateway.submit_job("knn-join", "go", model="transe",
                               classes=ids[:4], k=3)
        assert time.perf_counter() - t0 < 1.0
        assert e.value.code == "OVERLOADED" and e.value.status == 429
        assert e.value.details["retry_after_s"] > 0
        assert gateway.jobs.stats()["rejected_overloaded"] == 1
    finally:
        gateway.close()


def test_poll_storm_exactly_once_and_monotone_progress(registry):
    ids = _publish(registry, "2024-01", seed=1)
    gateway = _slow_gw(registry)
    try:
        sub = gateway.submit_job("knn-join", "go", model="transe",
                                 classes=ids, k=5)
        results, errs = [], []
        lock = threading.Lock()

        def poller():
            try:
                seen = []
                while True:
                    st = gateway.job_status(sub.job_id)
                    seen.append(st.progress)
                    if st.state in ("DONE", "FAILED", "CANCELLED"):
                        break
                    time.sleep(0.001)
                assert seen == sorted(seen)
                assert st.state == "DONE"
                page = gateway.job_result(sub.job_id, limit=N)
                with lock:
                    results.append(json.dumps(page.rows, sort_keys=True))
            except Exception as e:                 # pragma: no cover
                with lock:
                    errs.append(e)

        threads = [threading.Thread(target=poller) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs
        assert len(set(results)) == 1 and len(results) == 16
        assert gateway.jobs.stats()["completed"] == 1
        assert gateway.job_status(sub.job_id).summary["slabs"] == \
            (N + 3) // 4
    finally:
        gateway.close()


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_http_job_roundtrip_etag_stream_and_taxonomy(gw):
    gateway, ids = gw
    server = serve_http(gateway, port=0)
    try:
        port = server.port
        st, _, body = _http(port, "POST", "/jobs/submit",
                            {"kind": "knn-join", "ontology": "go",
                             "model": "transe", "classes": ids[:8], "k": 3})
        assert st == 200
        jid = json.loads(body)["job_id"]
        # before DONE a matching-looking ETag never earns a 304
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st, _, body = _http(port, "GET", f"/jobs/{jid}")
            if json.loads(body)["state"] == "DONE":
                break
            time.sleep(0.01)
        assert json.loads(body)["state"] == "DONE"
        st, hdr, body = _http(port, "GET", f"/jobs/{jid}/result?limit=5")
        assert st == 200 and hdr.get("ETag") == job_etag(jid, 0, 5)
        page = json.loads(body)
        assert page["type"] == "job_result_page" and page["total"] == 8
        assert len(page["rows"]) == 5 and page["next_offset"] == 5
        st2, hdr2, body2 = _http(port, "GET", f"/jobs/{jid}/result?limit=5",
                                 headers={"If-None-Match": hdr["ETag"]})
        assert st2 == 304 and body2 == b""
        assert hdr2.get("ETag") == hdr["ETag"]
        st3, hdr3, body3 = _http(port, "GET",
                                 f"/jobs/{jid}/result?stream=true")
        assert st3 == 200
        assert hdr3.get("X-Bio-KGvec2go-Kind") == "knn-join"
        assert hdr3.get("X-Bio-KGvec2go-Job") == jid
        rows = json.loads(body3)
        assert rows == page["rows"] + json.loads(
            _http(port, "GET", f"/jobs/{jid}/result?offset=5")[2])["rows"]
        before = json.loads(_http(port, "GET", "/stats")[2])
        st4, _, body4 = _http(port, "GET", "/jobs/j0-404")
        assert st4 == 404 and json.loads(body4)["code"] == "JOB_NOT_FOUND"
        st5, _, body5 = _http(port, "POST", f"/jobs/{jid}/cancel", {})
        assert st5 == 400 and json.loads(body5)["code"] == "BAD_REQUEST"
        after = json.loads(_http(port, "GET", "/stats")[2])
        b0, b1 = before["gateway"]["by_code"], after["gateway"]["by_code"]
        assert b1.get("JOB_NOT_FOUND", 0) == b0.get("JOB_NOT_FOUND", 0) + 1
        assert b1.get("BAD_REQUEST", 0) == b0.get("BAD_REQUEST", 0) + 1
        assert after["gateway"]["jobs"]["completed"] == 1
    finally:
        server.close()


def test_async_gateway_submit_wait_result(gw):
    gateway, ids = gw

    async def main():
        ag = AsyncGateway(gateway)
        sub = await ag.submit_job("knn-join", "go", model="transe",
                                  classes=ids[:6], k=3)
        st = await ag.job_wait(sub.job_id, timeout=60)
        page = await ag.job_result(sub.job_id)
        listed = await ag.jobs_list()
        return st, page, listed

    st, page, listed = asyncio.run(main())
    assert st.state == "DONE"
    assert page.total == 6 and len(page.rows) == 6
    assert [j.job_id for j in listed.jobs] == [st.job_id]


def test_sigkilled_worker_reports_orphaned_job_failed(tmp_path):
    """SIGKILL the worker that owns a RUNNING job in a 2-worker pool on
    the CPU: the survivor (or the supervisor's replacement) answers polls
    with FAILED through the shared job state dir, and the failure sticks."""
    n = 256
    root = tmp_path / "reg"
    registry = EmbeddingRegistry(root)
    ids = _publish(registry, "2024-01", seed=0, n=n)
    registry.seal("go", "2024-01")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    state = tmp_path / "state"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.api.workers", "--registry",
         str(root), "--workers", "2", "--device", "cpu",
         "--stats-interval-ms", "200", "--state-dir", str(state)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("READY"), proc.stderr.read()
        port = int(line.split("port=")[1].split()[0])

        def poll(path, method="GET", body=None):
            for _ in range(50):
                try:
                    return _http(port, method, path, body)
                except OSError:
                    time.sleep(0.05)
            raise AssertionError("pool stopped answering")

        st, _, body = poll("/jobs/submit", "POST",
                           {"kind": "knn-join", "ontology": "go",
                            "model": "transe", "classes": ids * 250,
                            "k": 10})
        assert st == 200, body
        job = json.loads(body)
        jid, owner = job["job_id"], job["owner_pid"]
        assert owner in (int(p) for p in
                         line.split("pids=")[1].split()[0].split(","))
        assert (state / "jobs" / f"job-{jid}.json").exists()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            state_now = json.loads(poll(f"/jobs/{jid}")[2])["state"]
            if state_now == "RUNNING":
                break
            assert state_now == "PENDING", state_now
            time.sleep(0.01)
        os.kill(owner, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            job = json.loads(poll(f"/jobs/{jid}")[2])
            if job["state"] == "FAILED":
                break
            time.sleep(0.05)
        assert job["state"] == "FAILED" and "died" in job["error"]
        assert json.loads(poll(f"/jobs/{jid}")[2])["state"] == "FAILED"
        st, _, body = poll(f"/jobs/{jid}/result")
        assert st == 400
        assert json.loads(body)["details"]["state"] == "FAILED"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


# ------------------------------- the card ------------------------------ #
@pytest.mark.cuda
def test_knn_join_bit_equal_to_serial_top_k_rows_on_card(tmp_path):
    """On the card the join's ids and scores equal one ``top_k_rows``
    call per class, bit for bit, at both k paths (the kernel sums each
    (query, row) pair in column order whatever the batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    # the kernels' one-time nvcc build is set-up, as a pool does it before
    # it serves (api/workers.py), not part of the job that _run times
    _build.build_all()
    n, d = 3000, 200
    registry = EmbeddingRegistry(tmp_path / "registry")
    rng = np.random.default_rng(5)
    ids = [f"GO:{i:07d}" for i in range(n)]
    registry.publish("go", "2024-01", "transe", ids, ids,
                     rng.standard_normal((n, d)).astype(np.float32),
                     ontology_checksum="ck", hyperparameters={"dim": d})
    gateway = Gateway(ServingEngine(registry, device="cuda"))
    try:
        idx = gateway.engine._index("go", "transe")
        sample = sorted(rng.choice(n, 200, replace=False).tolist())
        for k in (10, 100):
            _, page = _run(gateway, "knn-join", model="transe",
                           classes=[ids[i] for i in sample], k=k)
            for row, (ident, hits) in zip(sample, page.rows):
                want = idx.top_k_rows([row], k)[0]
                assert ident == ids[row]
                assert [h[0] for h in hits] == [c.identifier for c in want]
                assert [h[1] for h in hits] == [c.score for c in want]
    finally:
        gateway.close()
