"""The port's snapshot store against the JAX package's, byte for byte.

The same arrays, published with the same ``generated_at`` by both
registries, must give byte-identical serve-layout files, and each
package must read the store the other wrote.
"""
import numpy as np
import pytest

from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro_torch.checkpoint import store as tstore
from repro_torch.core.registry import EmbeddingRegistry as TorchRegistry

N, D = 37, 12            # D = 12 pads every row to a 16-float stride
WHEN = "2025-01-01T00:00:00+00:00"


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    ids = [f"GO:{i:07d}" for i in range(N)]
    labels = [f"Term  {i % 31} of GO" for i in range(N)]   # repeats, spaces
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb[3] = 0.0                                            # a zero row
    return ids, labels, emb


def _publish(reg, version="2025-01", seed=0, lineage=None):
    ids, labels, emb = _arrays(seed)
    reg.publish("go", version, "transe", ids, labels, emb,
                ontology_checksum=f"ck-{seed}",
                hyperparameters={"dim": D, "lr": 0.01},
                train_stats={"loss": 0.5, "curve": [1, 2]},
                generated_at=WHEN, lineage=lineage)
    reg.seal("go", version)
    return ids, labels, emb


@pytest.fixture()
def both(tmp_path):
    jax_reg = JaxRegistry(tmp_path / "jax")
    torch_reg = TorchRegistry(tmp_path / "torch")
    for reg in (jax_reg, torch_reg):
        _publish(reg, lineage={"parent_version": None, "mode": "full",
                               "delta": None})
    return tmp_path, jax_reg, torch_reg


@pytest.mark.parametrize("name", ["transe/table.f32", "transe/table.json",
                                  "transe/metadata.json", ".published"])
def test_published_files_byte_identical(both, name):
    root, _, _ = both
    a = (root / "jax" / "go" / "2025-01" / name).read_bytes()
    b = (root / "torch" / "go" / "2025-01" / name).read_bytes()
    assert a == b


@pytest.mark.parametrize("reader,writer", [("torch", "jax"), ("jax", "torch")])
def test_each_package_reads_the_others_store(both, reader, writer):
    root, _, _ = both
    ids, labels, emb = _arrays()
    cls = TorchRegistry if reader == "torch" else JaxRegistry
    reg = cls(root / writer)
    table, norms, header = reg.store.open_table("go", "2025-01", "transe")
    np.testing.assert_array_equal(np.asarray(table), emb)
    np.testing.assert_array_equal(np.asarray(norms),
                                  np.linalg.norm(emb, axis=1).astype("<f4"))
    assert header["ids"] == ids and header["labels"] == labels
    s_ids, s_labels, s_table, s_norms, meta = reg.get_serving(
        "go", "transe")
    assert s_ids == ids and s_labels == labels
    np.testing.assert_array_equal(np.asarray(s_table), emb)
    assert meta["sorted_labels"] == header["sorted_labels"]
    assert reg.store.sealed_versions("go") == ["2025-01"]
    g_ids, g_labels, g_emb, g_meta = reg.get("go", "transe")
    assert g_ids == ids and g_labels == labels
    np.testing.assert_array_equal(g_emb, emb)


def test_version_order_and_params_round_trip(tmp_path):
    """Natural version order, params sidecars and the download payload
    agree between the two packages over one shared store."""
    jreg = JaxRegistry(tmp_path)
    treg = TorchRegistry(tmp_path)
    for v in ("2024-9", "2024-10", "v2"):
        _publish(jreg, v)
    assert treg.versions("go") == jreg.versions("go") == \
        ["2024-9", "2024-10", "v2"]
    assert tstore.version_sort_key("2024-10") > tstore.version_sort_key("2024-9")
    params = {"entity": np.arange(6, dtype=np.float32).reshape(3, 2)}
    treg.store.save_params("go", "v2", "transe", params, {"entity": ["a", "b", "c"]})
    p, vocab = jreg.get_params("go", "transe", "v2")
    np.testing.assert_array_equal(p["entity"], params["entity"])
    assert vocab == {"entity": ["a", "b", "c"]}
    assert treg.to_json("go", "transe") == jreg.to_json("go", "transe")
    assert treg.published_checksum("go") == jreg.published_checksum("go")
