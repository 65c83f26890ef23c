"""The port's gateway and HTTP layer against the JAX package's.

One store published by the reference is served by ``repro.api.Gateway``
and ``repro_torch.api.Gateway`` (``device="cpu"``).  ``Gateway.handle``
must give byte-identical wire bodies route by route (the JSON dump of
each dict compared as a string), except the scores of closest-concepts:
ids exact, scores within 1e-5 (fp32 sums in another order).
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.api import Gateway as JaxGateway
from repro.api import schema as jschema
from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro.core.serving import ServingEngine as JaxEngine
from repro_torch.api import Gateway, serve_http
from repro_torch.api import schema as tschema
from repro_torch.core.registry import EmbeddingRegistry as TorchRegistry
from repro_torch.core.serving import ServingEngine

N, D = 40, 12


def _publish(reg, version, seed, lineage):
    rng = np.random.default_rng(seed)
    ids = [f"GO:{i:07d}" for i in range(N)]
    labels = [f"go term {i}" for i in range(N)]
    emb = rng.standard_normal((N, D)).astype(np.float32)
    reg.publish("go", version, "transe", ids, labels, emb,
                ontology_checksum=f"ck-{version}",
                hyperparameters={"dim": D}, lineage=lineage)
    reg.seal("go", version)
    return ids


@pytest.fixture()
def gateways(tmp_path):
    reg = JaxRegistry(tmp_path)
    ids = _publish(reg, "2024-01", 1, {"parent_version": None,
                                       "mode": "full", "delta": None})
    _publish(reg, "2024-02", 2, {"parent_version": "2024-01",
                                 "mode": "incremental",
                                 "delta": {"churn_fraction": 0.1}})
    ref = JaxGateway(JaxEngine(reg, cache_capacity=4))
    port = Gateway(ServingEngine(TorchRegistry(tmp_path), cache_capacity=4,
                                 device="cpu"))
    yield ref, port, ids
    ref.close()
    port.close()


IDS = [f"GO:{i:07d}" for i in range(N)]
WIRE_CASES = [
    ("/download/go/transe", {}),
    ("/download/go/transe", {"version": "2024-01", "offset": 3, "limit": 7}),
    ("/download/go/transe", {"offset": 35, "limit": 20_000}),
    ("/get-vector/go/transe", {"query": IDS[3]}),
    ("/get-vector/go/transe", {"query": "GO TERM  8", "version": "2024-01"}),
    ("/get-vector/go/transe", {"query": "go trm 9", "fuzzy": True}),
    ("/sim/go/transe", {"a": IDS[0], "b": IDS[1]}),
    ("/sim/go/transe", {"a": "go term 4", "b": IDS[30],
                        "version": "2024-01"}),
    ("/autocomplete/go/transe", {"prefix": "go term 1", "limit": 4}),
    ("/autocomplete/go/transe", {"prefix": "zz"}),
    ("/versions/go", {}),
    ("/lineage/go", {}),
    ("/lineage/go", {"version": "2024-01"}),
    ("/health", {}),
    # every error body
    ("/sim/nope/transe", {"a": IDS[0], "b": IDS[1]}),
    ("/sim/go/distmult", {"a": IDS[0], "b": IDS[1]}),
    ("/sim/go/transe", {"a": "no such class", "b": "nor this"}),
    ("/get-vector/go/transe", {"query": "no such class"}),
    ("/download/go/transe", {"version": "1999-01"}),
    ("/closest-concepts/go/transe", {"query": IDS[0], "k": 0}),
    ("/closest-concepts/go/transe", {"query": IDS[0], "k": "ten"}),
    ("/closest-concepts/go/transe", {"query": IDS[0], "colour": "red"}),
    ("/closest-concepts/go/transe", {"query": "no such class"}),
    ("/closest-concepts/go/transe", {"query": ""}),
    ("/no/such/route/at/all", {}),
    ("/sim/go/transe", {"a": IDS[0], "b": IDS[1], "ontology": "hp"}),
]


@pytest.mark.parametrize("route,payload", WIRE_CASES)
def test_wire_bodies_byte_identical(gateways, route, payload):
    ref, port, _ = gateways
    want = json.dumps(ref.handle(route, dict(payload)))
    got = json.dumps(port.handle(route, dict(payload)))
    assert got == want


@pytest.mark.parametrize("k,version", [(1, None), (5, None), (39, "2024-01"),
                                       (100, None)])
def test_closest_concepts_ids_exact_scores_close(gateways, k, version):
    ref, port, ids = gateways
    payload = {"query": ids[7], "k": k, "version": version}
    want = ref.handle("/closest-concepts/go/transe", dict(payload))
    got = port.handle("/closest-concepts/go/transe", dict(payload))
    w_hits, g_hits = want.pop("results"), got.pop("results")
    assert got == want
    assert [h["identifier"] for h in g_hits] == \
        [h["identifier"] for h in w_hits]
    assert [(h["label"], h["url"]) for h in g_hits] == \
        [(h["label"], h["url"]) for h in w_hits]
    np.testing.assert_allclose([h["score"] for h in g_hits],
                               [h["score"] for h in w_hits], rtol=0,
                               atol=1e-5)
    assert len(g_hits) == min(k, N - 1)


def test_schema_tables_equal_reference():
    assert tschema.CODE_STATUS == jschema.CODE_STATUS
    assert {c: e.__name__ for c, e in tschema._LEGACY.items()} == \
        {c: e.__name__ for c, e in jschema._LEGACY.items()}
    assert {c.__name__: n for c, n in tschema._TYPES.items()} == \
        {c.__name__: n for c, n in jschema._TYPES.items()}


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_round_trip_and_not_modified(gateways):
    ref, port, ids = gateways
    server = serve_http(port, port=0)
    try:
        base = server.url
        st, hdr, body = _get(f"{base}/download/go/transe?offset=2&limit=5")
        assert st == 200
        assert json.loads(body) == ref.handle(
            "/download/go/transe", {"offset": 2, "limit": 5})
        etag = hdr["ETag"]
        st, hdr, body = _get(f"{base}/download/go/transe?offset=2&limit=5",
                             {"If-None-Match": etag})
        assert st == 304 and body == b"" and hdr["ETag"] == etag
        assert server.http_counts()["not_modified"] == 1
        st, _, body = _get(f"{base}/get-vector/go/transe?query={ids[4]}")
        assert st == 200 and json.loads(body) == ref.handle(
            "/get-vector/go/transe", {"query": ids[4]})
        st, _, body = _get(f"{base}/closest-concepts/go/transe"
                           f"?query={ids[4]}&k=3")
        assert st == 200
        assert [h["identifier"] for h in json.loads(body)["results"]] == \
            [h["identifier"] for h in ref.handle(
                "/closest-concepts/go/transe",
                {"query": ids[4], "k": 3})["results"]]
        st, _, body = _get(f"{base}/sim/go/transe?a=nope&b={ids[1]}")
        assert st == 404 and json.loads(body)["code"] == "UNKNOWN_CLASS"
        st, hdr, body = _get(f"{base}/download/go/transe?stream=true&limit=9")
        assert st == 200 and hdr.get("Transfer-Encoding") == "chunked"
        assert list(json.loads(body)) == ids[:9]
    finally:
        server.close()
