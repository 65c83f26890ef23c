"""The port's ``ServingEngine`` delegate surface against the JAX package's.

One store is published by the reference from a seed and copied; the
reference's engine serves one copy and the port's (``device="cpu"``: the
plain PyTorch top-k) the other.  The five deprecated delegates
(``download``, ``get_vector``, ``similarity``, ``closest_concepts``,
``autocomplete``), ``gateway()``, ``EmbeddingIndex.unit`` and
``device_table_bytes()`` must give the reference's answers: downloads,
vectors, similarities, completions and unit rows exactly (both packages
compute them on the host in numpy), closest-concepts ids exactly and
scores within 1e-5 (fp32 sums in another order); and the reference's
exception types (``KeyError`` for an unknown ontology, model, version or
class, ``ValueError`` for a bad request), which the delegates translate
back from the gateway's ``ApiError``.  The contracts are those of
``tests/test_serving_engine.py`` and ``tests/test_gateway.py``.
"""
import json
import shutil

import numpy as np
import pytest

from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro.core.serving import ServingEngine as JaxEngine
from repro_torch.api import Gateway
from repro_torch.core.registry import EmbeddingRegistry as TorchRegistry
from repro_torch.core.serving import ServingEngine

N, D = 40, 12
TOL = 1e-5
VERSIONS = ("2024-01", "2024-02")


def _publish(reg, version, seed):
    rng = np.random.default_rng(seed)
    ids = [f"GO:{i:07d}" for i in range(N)]
    labels = [f"go term {i}" for i in range(N)]
    emb = (rng.standard_normal((N, D)) * rng.uniform(0.5, 2, (N, 1))
           ).astype(np.float32)
    reg.publish("go", version, "transe", ids, labels, emb,
                ontology_checksum=f"ck-{version}-{seed}",
                hyperparameters={"dim": D})
    reg.seal("go", version)
    return ids


@pytest.fixture()
def engines(tmp_path):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    reg = JaxRegistry(ref_root)
    for seed, version in enumerate(VERSIONS, start=1):
        ids = _publish(reg, version, seed)
    shutil.copytree(ref_root, port_root)
    ref = JaxEngine(JaxRegistry(ref_root), cache_capacity=4)
    port = ServingEngine(TorchRegistry(port_root), cache_capacity=4,
                         device="cpu")
    yield ref, port, ids, port_root
    ref.gateway().close()
    port.gateway().close()


@pytest.mark.parametrize("version", [None, *VERSIONS])
def test_download_and_get_vector_match_reference(engines, version):
    ref, port, ids, _ = engines
    got = port.download("go", "transe", version)
    assert got == ref.download("go", "transe", version)
    assert len(json.loads(got)) == N
    for query, fuzzy in ((ids[3], False), ("GO TERM  8", False),
                         ("go trm 9", True)):
        g = port.get_vector("go", "transe", query, fuzzy=fuzzy,
                            version=version)
        w = ref.get_vector("go", "transe", query, fuzzy=fuzzy,
                           version=version)
        assert g.dtype == np.float32 and np.array_equal(g, w)


@pytest.mark.parametrize("version", [None, *VERSIONS])
def test_similarity_and_autocomplete_match_reference(engines, version):
    ref, port, ids, _ = engines
    for a, b, fuzzy in ((ids[0], ids[1], False), ("go term 4", ids[30], False),
                        ("go trm 5", ids[7], True)):
        assert port.similarity("go", "transe", a, b, fuzzy=fuzzy,
                               version=version) == \
            ref.similarity("go", "transe", a, b, fuzzy=fuzzy, version=version)
    for prefix, limit in (("go term 1", 4), ("go term 3", 20), ("zz", 10)):
        assert port.autocomplete("go", "transe", prefix, limit=limit,
                                 version=version) == \
            ref.autocomplete("go", "transe", prefix, limit=limit,
                             version=version)


@pytest.mark.parametrize("k", [1, 5, N - 1, N + 5])
def test_closest_concepts_match_reference(engines, k):
    ref, port, ids, _ = engines
    for query, version in ((ids[3], None), ("go term 12", "2024-01")):
        got = port.closest_concepts("go", "transe", query, k=k,
                                    version=version)
        want = ref.closest_concepts("go", "transe", query, k=k,
                                    version=version)
        assert [(c.identifier, c.label, c.url) for c in got] == \
            [(c.identifier, c.label, c.url) for c in want]
        np.testing.assert_allclose([c.score for c in got],
                                   [c.score for c in want], rtol=0, atol=TOL)


def test_delegates_share_the_engines_gateway(engines):
    """``gateway()`` is built once; the delegates' similarity and top-k
    traffic goes through its BatchScheduler."""
    _, port, ids, _ = engines
    gw = port.gateway()
    assert isinstance(gw, Gateway) and port.gateway() is gw
    port.similarity("go", "transe", ids[0], ids[1])
    port.closest_concepts("go", "transe", ids[0], k=3)
    st = gw.scheduler.stats
    assert st["submitted"] >= 2 and st["resolved"] == st["submitted"]


CALLS = {
    "download": lambda e, o, m, q, v: e.download(o, m, v),
    "get_vector": lambda e, o, m, q, v: e.get_vector(o, m, q, version=v),
    "similarity": lambda e, o, m, q, v: e.similarity(o, m, q, q, version=v),
    "closest_concepts": lambda e, o, m, q, v: e.closest_concepts(
        o, m, q, k=3, version=v),
    "autocomplete": lambda e, o, m, q, v: e.autocomplete(o, m, "go",
                                                         version=v),
}
#: (ontology, model, query, version): an unknown coordinate each, and a
#: class no table holds (for the three delegates that take one)
UNKNOWN = {"ontology": ("mars", "transe", "GO:0000001", None),
           "model": ("go", "no-model", "GO:0000001", None),
           "version": ("go", "transe", "GO:0000001", "1999-01"),
           "class": ("go", "transe", "NOPE", None)}
UNKNOWN_CASES = [(call, what) for call in sorted(CALLS) for what in UNKNOWN
                 if what != "class" or call not in ("download",
                                                    "autocomplete")]


@pytest.mark.parametrize("call,what", UNKNOWN_CASES)
def test_unknown_coordinates_raise_the_references_type(engines, call, what):
    ref, port, _, _ = engines
    coords = UNKNOWN[what]
    raised = []
    for engine in (ref, port):
        with pytest.raises(Exception) as ei:
            CALLS[call](engine, *coords)
        raised.append(type(ei.value))
    assert raised[1] is raised[0]
    assert issubclass(raised[1], KeyError)


def test_similarity_reports_every_missing_class(engines):
    ref, port, _, _ = engines
    for engine in (ref, port):
        with pytest.raises(KeyError) as ke:
            engine.similarity("go", "transe", "BOGUS-A", "BOGUS-B",
                              fuzzy=True)
        assert "BOGUS-A" in str(ke.value) and "BOGUS-B" in str(ke.value)


@pytest.mark.parametrize("k", [0, -3, "ten"])
def test_bad_k_raises_value_error(engines, k):
    ref, port, ids, _ = engines
    for engine in (ref, port):
        with pytest.raises(ValueError):
            engine.closest_concepts("go", "transe", ids[0], k=k)


@pytest.mark.parametrize("version", VERSIONS)
def test_index_unit_and_device_table_bytes(engines, version):
    """``unit`` is the whole L2-normalised table, bit-equal to the
    reference's and to ``unit_rows``; the port's table stays on the host,
    so no table byte is pinned on a device."""
    ref, port, _, _ = engines
    got = port._index("go", "transe", version)
    want = ref._index("go", "transe", version)
    assert got.unit.dtype == np.float32 and got.unit.shape == (N, D)
    assert np.array_equal(got.unit, want.unit)
    assert np.array_equal(got.unit[5:9], got.unit_rows(slice(5, 9)))
    assert got.device_table_bytes() == 0 == want.device_table_bytes()


def test_launch_serve_accepts_no_shard(engines, capsys):
    """``--no-shard`` is the reference's flag: on the port's one device it
    runs the same single-device session."""
    from repro_torch.launch import serve
    _, _, _, root = engines
    out = serve.main(["--registry", str(root), "--device", "cpu",
                      "--no-shard", "--requests", "16", "--batch", "8",
                      "--threads", "2", "--k", "5"])
    assert out["classes"] == N and out["requests"] == 16
    assert "health=ok" in capsys.readouterr().out
