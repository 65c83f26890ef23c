"""The port's serving core against the JAX package's, on one store.

One store is published by the reference; ``repro.core.serving`` and
``repro_torch.core.serving`` (``device="cpu"``: the plain PyTorch top-k)
serve it side by side.  ids must match exactly, top-k scores within 1e-5
(fp32 sums in another order), and pair similarity exactly (both packages
compute it on the host in numpy).
"""
import sys
import threading

import numpy as np
import pytest

from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro.core.serving import ServingEngine as JaxEngine
from repro_torch.core.registry import EmbeddingRegistry as TorchRegistry
from repro_torch.core.serving import (BatchScheduler, SchedulerError,
                                      ServingEngine, TopKRequest)

N, D = 60, 16
TOL = 1e-5


def _publish(reg, version, seed):
    rng = np.random.default_rng(seed)
    ids = [f"GO:{i:07d}" for i in range(N)]
    labels = [f"go term {i} kind {i % 7}" for i in range(N)]
    emb = (rng.standard_normal((N, D)) * rng.uniform(0.5, 2, (N, 1))
           ).astype(np.float32)
    reg.publish("go", version, "transe", ids, labels, emb,
                ontology_checksum=f"ck-{seed}", hyperparameters={"dim": D})
    reg.seal("go", version)
    return ids, labels


@pytest.fixture()
def engines(tmp_path):
    ref_reg = JaxRegistry(tmp_path)
    ids, labels = _publish(ref_reg, "2024-01", seed=1)
    ref = JaxEngine(ref_reg, cache_capacity=4)
    port = ServingEngine(TorchRegistry(tmp_path), cache_capacity=4,
                         device="cpu")
    return ref, port, ids, labels, tmp_path


def _same_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c.identifier for c in g] == [c.identifier for c in w]
        assert [c.label for c in g] == [c.label for c in w]
        assert [c.url for c in g] == [c.url for c in w]
        np.testing.assert_allclose([c.score for c in g],
                                   [c.score for c in w], rtol=0, atol=TOL)


@pytest.mark.parametrize("k", [1, 10, N - 1, N, N + 5])
def test_top_k_matches_reference(engines, k):
    ref, port, ids, _, _ = engines
    queries = [ids[0], ids[N - 1], "go term 5 kind 5", ids[17]]
    a = ref._index("go", "transe").top_k(queries, k=k)
    b = port._index("go", "transe").top_k(queries, k=k)
    _same_hits(b, a)
    assert all(len(h) == min(k, N - 1) for h in b)


@pytest.mark.parametrize("method", ["similarity", "autocomplete",
                                    "resolve_fuzzy", "vector", "knn_join"])
def test_index_methods_match_reference(engines, method):
    ref, port, ids, labels, _ = engines
    ri, pi = ref._index("go", "transe"), port._index("go", "transe")
    if method == "similarity":
        for a, b in [(ids[0], ids[1]), (labels[3], ids[40]),
                     ("GO TERM 9 KIND 2", labels[9])]:
            assert pi.similarity(a, b) == ri.similarity(a, b)   # exact
        with pytest.raises(KeyError):
            pi.similarity("nope", ids[0])
    elif method == "autocomplete":
        for prefix, limit in [("go term 1", 5), ("GO  TERM 4", 3),
                              ("zzz", 10), ("go", 100)]:
            assert pi.autocomplete(prefix, limit) == \
                ri.autocomplete(prefix, limit)
    elif method == "resolve_fuzzy":
        for q in ["go term 12 kind 6", "go trm 12 kind 5", "xx", "go term 3"]:
            assert pi.resolve_fuzzy(q) == ri.resolve_fuzzy(q)
    elif method == "vector":
        for q in [ids[5], labels[8]]:
            np.testing.assert_array_equal(pi.vector(q), ri.vector(q))
    else:
        rows = list(range(0, N, 2))
        a = list(ri.knn_join_rows(rows, k=4, slab=8))
        b = list(pi.knn_join_rows(rows, k=4, slab=8))
        assert [s for s, _ in a] == [s for s, _ in b] == [0, 8, 16, 24]
        for (_, ha), (_, hb) in zip(a, b):
            _same_hits(hb, ha)
        # and the join agrees with per-row top_k on the port itself
        flat = [h for _, hs in b for h in hs]
        _same_hits(flat, pi.top_k_rows(rows, k=4))


def test_scheduler_16_threads_resolve_exactly_once(engines):
    """16 client threads against the flush loop: every ticket resolves
    exactly once, with the same result as a direct top-k."""
    _, port, ids, _, _ = engines
    sched = BatchScheduler(port, max_batch=8, flush_after_ms=1.0)
    per_thread = 12
    results = {}
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(t):
            mine = []
            for j in range(per_thread):
                q = ids[(t * per_thread + j) % N]
                mine.append((q, sched.submit(TopKRequest("go", "transe", q,
                                                         k=5))))
            for q, ticket in mine:
                res = ticket.result(timeout=60)
                with lock:
                    results[ticket.id] = (q, res)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        bad = sched.submit(TopKRequest("go", "transe", "no such class"))
        with pytest.raises(SchedulerError) as ei:
            bad.result(timeout=30)
        assert ei.value.code == "UNKNOWN_CLASS"
    finally:
        sys.setswitchinterval(old)
        sched.stop()
    assert len(results) == 16 * per_thread
    assert sched.stats["submitted"] == sched.stats["resolved"] == \
        16 * per_thread + 1
    assert sched.stats["failed"] == 1
    index = port._index("go", "transe")
    for q, res in results.values():
        assert [c.identifier for c in res] == \
            [c.identifier for c in index.top_k([q], k=5)[0]]


def test_invalidate_to_a_second_version_and_drop_version(engines):
    ref, port, ids, _, root = engines
    assert port.latest_version("go") == "2024-01"
    port._index("go", "transe")
    _publish(JaxRegistry(root), "2024-02", seed=2)
    seen = []
    port.add_invalidate_listener(lambda o, v: seen.append((o, v)))
    assert port.invalidate("go") == "2024-02"
    assert seen == [("go", "2024-02")]
    assert ("go", "transe", "2024-02") in port.cache     # warm-built
    ref.invalidate("go")
    _same_hits(port._index("go", "transe").top_k([ids[3]], k=6),
               ref._index("go", "transe").top_k([ids[3]], k=6))
    # the old version stays servable when pinned, until dropped
    old = port._index("go", "transe", "2024-01").top_k([ids[3]], k=6)
    assert old[0][0].identifier != "" and len(old[0]) == 6
    assert port.drop_version("go", "2024-02") == 1
    assert ("go", "transe", "2024-02") not in port.cache
    assert port.latest_version("go") == "2024-02"        # re-resolved


def test_launch_serve_session_over_a_reference_store(engines, capsys):
    """The slice end to end on the CPU: the port's launcher serves a store
    the reference published (download, sim, concurrent closest-concepts
    through the flush loop, ops routes) and reports its measurements."""
    from repro_torch.launch import serve
    _, _, _, _, root = engines
    out = serve.main(["--registry", str(root), "--device", "cpu",
                      "--requests", "48", "--batch", "8", "--threads", "4",
                      "--k", "5"])
    assert out["classes"] == N and out["requests"] == 48
    assert out["micro_batches"] >= 48 // 8 and out["qps"] > 0
    assert out["p50_ms"] <= out["p99_ms"]
    assert "health=ok" in capsys.readouterr().out
