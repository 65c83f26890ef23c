"""The port's update path against the JAX package's, on the CPU.

``repro_torch.core.updater.Updater`` (``device="cpu"``: the plain PyTorch
kernels) and ``repro.core.updater.Updater`` run the same release series:
the same plans, snapshots that warm-start across the two packages in both
directions, and trained quality within ``bench_update``'s MRR band
(max(0.05, 0.15 * MRR of the reference)) at the same step budget.  The
two trainers draw different random numbers, so only the plans, the
carried rows and the quality band are compared, never trained values.
"""
import numpy as np
import pytest
import torch

from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro.core.updater import SyntheticReleaseChannel as JaxChannel
from repro.core.updater import Updater as JaxUpdater
from repro.kge import make_model as jmake_model
from repro.kge import rank_based_eval as jeval
from repro.kge.train import TrainConfig as JaxTrainConfig
from repro.ontology import synthetic as jsyn

import repro.configs.go_kge as jgo
import repro_torch.configs.go_kge as tgo
from repro_torch.api import Gateway
from repro_torch.core.registry import EmbeddingRegistry
from repro_torch.core.serving import ServingEngine
from repro_torch.core.updater import (SyntheticReleaseChannel, Updater,
                                      poll_loop)
from repro_torch.kge import make_model, params_from_numpy, rank_based_eval
from repro_torch.kge.train import KGETrainer, TrainConfig
from repro_torch.launch import train as tlaunch
from repro_torch.ontology import synthetic as tsyn

MODELS = ("transe", "distmult")
CALM = dict(add_frac=0.02, obsolete_frac=0.005, rewire_frac=0.005)
WILD = dict(add_frac=0.5, obsolete_frac=0.05, rewire_frac=0.3)
FAST = dict(batch_size=64, num_negs=4, lr=5e-2)


def _port(reg, engine=None, steps=20, models=MODELS, **kw):
    return Updater(reg, engine=engine, models=models, dim=16,
                   train_cfg=TrainConfig(**FAST), steps_override=steps,
                   device="cpu", **kw)


def _ref(reg, steps=20, models=MODELS, **kw):
    return JaxUpdater(reg, models=models, dim=16,
                      train_cfg=JaxTrainConfig(**FAST), steps_override=steps,
                      **kw)


def _series(n=4, n_terms=150, **kw):
    return tsyn.release_series(tsyn.GO_SPEC, n, seed=2, n_terms=n_terms,
                               **(kw or CALM))


# ------------------------------- plans -------------------------------- #
@pytest.mark.parametrize("evolve_kw", [CALM, WILD], ids=["calm", "wild"])
def test_plans_match_the_reference_over_a_release_series(tmp_path, evolve_kw):
    series = _series(3, **evolve_kw)
    jseries = jsyn.release_series(jsyn.GO_SPEC, 3, seed=2, n_terms=150,
                                  **evolve_kw)
    port, ref = (_port(EmbeddingRegistry(tmp_path / "p"), steps=2),
                 _ref(JaxRegistry(tmp_path / "r"), steps=2))
    pch, rch = SyntheticReleaseChannel("go"), JaxChannel("go")
    for (tag, kg), (jtag, jkg) in zip(series, jseries):
        pch.bump(tag, kg)
        rch.bump(jtag, jkg)
        got, _ = port.plan(pch)
        want, _ = ref.plan(rch)
        assert (got.mode, got.reason, got.parent_version, got.checksum) \
            == (want.mode, want.reason, want.parent_version, want.checksum)
        assert (got.delta is None) == (want.delta is None)
        if got.delta is not None:
            assert got.delta.stats() == want.delta.stats()
        prep, rrep = port.run_once(pch), ref.run_once(rch)
        assert (prep.mode, prep.trained_models) == (rrep.mode,
                                                    rrep.trained_models)
        # an unchanged release is a no-op for both
        assert port.plan(pch)[0].mode == ref.plan(rch)[0].mode == "noop"


# ------------------------------ run_once ------------------------------ #
def test_run_once_publishes_seals_and_invalidates(tmp_path):
    """At the REDUCED workload's size: published, sealed, and the engine
    answers from the new version."""
    wl = tgo.REDUCED
    series = tsyn.release_series(wl.spec, 2, seed=0, n_terms=wl.n_terms,
                                 **CALM)
    reg = EmbeddingRegistry(tmp_path)
    engine = ServingEngine(reg, device="cpu")
    upd = Updater(reg, engine=engine, models=MODELS, dim=wl.dim,
                  train_cfg=wl.train, steps_override=6, device="cpu")
    ch = SyntheticReleaseChannel("go")
    (v1, kg1), (v2, kg2) = series
    ch.bump(v1, kg1)
    rep1 = upd.run_once(ch)
    assert rep1.mode == "full" and rep1.trained_models == list(MODELS)
    assert reg.store.is_sealed("go", v1) and reg.store.has_graph("go", v1)
    gw = Gateway(engine, max_batch=8, flush_after_ms=1.0)
    first = gw.closest_concepts("go", "transe", kg1.entities[3], k=5)
    assert len(first.results) == 5 and first.version == v1

    ch.bump(v2, kg2)
    rep2 = upd.run_once(ch, seed=1)
    assert rep2.mode == "incremental" and rep2.parent_version == v1
    assert reg.store.is_sealed("go", v2)
    assert engine.latest_version("go") == v2
    for m in MODELS:
        det = rep2.details[m]
        assert det["mode"] == "incremental" and det["steps"] == 2
        assert det["carried_rows"] > 0.9 * kg1.num_entities
        assert det["losses"][-1] == (1, det["final_loss"])
        assert np.isfinite(det["losses"][0][1])
        ids, _, emb, meta = reg.get("go", m, v2)
        params, vocab = reg.get_params("go", m, v2)
        assert ids == list(kg2.entities) == vocab["entity"]
        np.testing.assert_array_equal(emb, params["entity"])
        assert emb.shape == (kg2.num_entities, wl.dim)
        assert meta["lineage"]["parent_version"] == v1
        assert meta["lineage"]["mode"] == "incremental"
    new = [e for e in kg2.entities if e not in set(kg1.entities)][0]
    resp = gw.closest_concepts("go", "distmult", new, k=5)
    gw.close()
    assert resp.version == v2 and len(resp.results) == 5
    assert all(h.identifier != new for h in resp.results)
    assert rep2.delta["churn_fraction"] < upd.churn_threshold


def test_warm_start_survives_restart_and_wild_churn_goes_full(tmp_path):
    series = _series(3)
    reg = EmbeddingRegistry(tmp_path)
    ch = SyntheticReleaseChannel("go")
    ch.bump(*series[0])
    _port(reg).run_once(ch)
    ch.bump(*series[1])
    rep = _port(reg).run_once(ch)             # a fresh updater, same store
    assert rep.mode == "incremental"
    wild = tsyn.evolve(series[1][1], tsyn.GO_SPEC, seed=9, **WILD)
    ch.bump("2030-01-01", wild)
    rep = _port(reg).run_once(ch)
    assert rep.mode == "full" and "churn" in rep.reason
    assert _port(reg, churn_threshold=0.0).plan(ch)[0].mode == "noop"


def test_poll_loop_seeds_each_round(tmp_path):
    reg = EmbeddingRegistry(tmp_path)
    ch = SyntheticReleaseChannel("go", *_series(1)[0])
    seen = []
    reps = poll_loop(_port(reg), [ch], iterations=2, base_seed=5,
                     on_report=seen.append)
    assert [r.mode for r in reps] == ["full", "noop"] and seen == reps


# ---------------------- snapshots across packages --------------------- #
@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_version_published_by_one_package_warm_starts_the_other(
        tmp_path, first):
    series = _series(2)
    (v1, kg1), (v2, kg2) = series
    jreg, preg = JaxRegistry(tmp_path), EmbeddingRegistry(tmp_path)
    if first == "jax":
        _ref(jreg).run_once(JaxChannel("go", v1, kg1))
        second = _port(preg)
        rep = second.run_once(SyntheticReleaseChannel("go", v2, kg2))
    else:
        _port(preg).run_once(SyntheticReleaseChannel("go", v1, kg1))
        rep = _ref(jreg).run_once(JaxChannel("go", v2, kg2))
    assert rep.mode == "incremental" and rep.parent_version == v1
    v1_params = {m: preg.get_params("go", m, v1)[0] for m in MODELS}
    carried = set(kg1.entities) & set(kg2.entities)
    for m in MODELS:
        det = rep.details[m]
        assert det["mode"] == "incremental"
        assert det["carried_rows"] == len(carried)
    # the reader of either package sees both versions
    for reg in (jreg, preg):
        assert reg.versions("go") == [v1, v2]
        assert reg.store.is_sealed("go", v2)
    # a port trainer warm-started from the v1 params carries them exactly
    model = make_model("transe", kg2.num_entities, kg2.num_relations, dim=16)
    tr = KGETrainer(model, TrainConfig(**FAST), device="cpu")
    from repro_torch.kge import vocab_remap
    e_map = vocab_remap(kg1.entities, kg2.entities)
    params, _, stats = tr.warm_init(v1_params["transe"], e_map,
                                    vocab_remap(kg1.relations, kg2.relations))
    keep = e_map >= 0
    np.testing.assert_array_equal(params["entity"].numpy()[keep],
                                  v1_params["transe"]["entity"][e_map[keep]])
    assert stats["entity_carried"] == len(carried)


# --------------------------- trained quality -------------------------- #
@pytest.mark.parametrize("model", MODELS)
def test_trained_mrr_within_the_band_of_the_reference(tmp_path, model):
    """REDUCED size (400 terms), the reference's TrainConfig, 240 steps for
    both packages; filtered MRR over every triple of the release."""
    wl = tgo.REDUCED
    kg = tsyn.generate(wl.spec, seed=0, n_terms=wl.n_terms)
    jkg = jsyn.generate(jsyn.GO_SPEC, seed=0, n_terms=wl.n_terms)
    steps = 240
    port = Updater(EmbeddingRegistry(tmp_path / "p"), models=(model,),
                   dim=wl.dim, train_cfg=wl.train, steps_override=steps,
                   device="cpu")
    ref = JaxUpdater(JaxRegistry(tmp_path / "r"), models=(model,),
                     dim=wl.dim, train_cfg=jgo.REDUCED.train,
                     steps_override=steps)
    port.run_once(SyntheticReleaseChannel("go", "v1", kg))
    ref.run_once(JaxChannel("go", "v1", jkg))
    tm = make_model(model, kg.num_entities, kg.num_relations, dim=wl.dim)
    jm = jmake_model(model, kg.num_entities, kg.num_relations, dim=wl.dim)
    tparams = params_from_numpy(
        tm, port.registry.get_params("go", model, "v1")[0], "cpu")
    jparams = ref.registry.get_params("go", model, "v1")[0]
    got = rank_based_eval(tm, tparams, kg.triples, kg.triples)["mrr"]
    want = jeval(jm, jparams, jkg.triples, jkg.triples)["mrr"]
    band = max(0.05, 0.15 * want)
    assert abs(got - want) <= band, (got, want, band)


# -------------------------- ported models only ------------------------ #
def test_unported_models_are_refused_by_name(tmp_path):
    """No paper model is left unported: the default is the paper's six;
    a model the port does not have is refused by name."""
    reg = EmbeddingRegistry(tmp_path)
    assert Updater(reg, device="cpu").models == (
        "transe", "transr", "distmult", "hole", "boxe", "rdf2vec")
    Updater(reg, models=("transe", "transr"), device="cpu")
    with pytest.raises(KeyError, match="nope"):
        Updater(reg, models=("transe", "nope"), device="cpu")


def test_launcher_needs_models_and_trains_them(tmp_path, capsys):
    """Without --models the launcher trains the workload's six; --models
    picks a subset of them and refuses anything else."""
    rep = tlaunch.main(["--workload", "go", "--registry",
                        str(tmp_path / "six"), "--device", "cpu",
                        "--n-terms", "100", "--steps", "2"])
    assert rep.trained_models == list(tgo.CONFIG.models)
    assert sorted(EmbeddingRegistry(tmp_path / "six").models("go")) \
        == sorted(tgo.CONFIG.models)
    with pytest.raises(SystemExit, match="workload has"):
        tlaunch.main(["--workload", "hp", "--registry", str(tmp_path),
                      "--models", "transe,bogus", "--device", "cpu"])
    rep = tlaunch.main(["--workload", "hp", "--registry", str(tmp_path),
                        "--models", "transe,distmult", "--device", "cpu",
                        "--n-terms", "80", "--steps", "3"])
    assert rep.mode == "full" and rep.trained_models == ["transe", "distmult"]
    assert EmbeddingRegistry(tmp_path).models("hp") == ["distmult", "transe"]
    assert "published" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["Updater", "KGETrainer", "launch.train"])
def test_update_entry_points_need_the_card_unless_asked_for_cpu(entry,
                                                                tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    model = make_model("transe", 5, 1, dim=4)
    calls = {
        "Updater": lambda dev: Updater(EmbeddingRegistry(tmp_path),
                                       models=MODELS, device=dev),
        "KGETrainer": lambda dev: KGETrainer(model, TrainConfig(),
                                             device=dev),
        "launch.train": lambda dev: tlaunch.main(
            ["--workload", "go", "--registry", str(tmp_path), "--models",
             "transe", "--n-terms", "40", "--steps", "1"]
            + ([] if dev is None else ["--device", dev])),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](None)
    calls[entry]("cpu")


@pytest.mark.cuda
def test_update_path_on_card(tmp_path):
    """A short run_once on the card goes through both kge_score kernels:
    each model's fit runs its warm-up steps eagerly, captures the step
    once (the counters see each kernel once there) and replays it for the
    rest of its 10 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from repro_torch.kernels import kge_score as tk
    from repro_torch.kge.train import GRAPH_WARMUP_STEPS
    reg = EmbeddingRegistry(tmp_path)
    tk.reset_launches()
    upd = Updater(reg, models=MODELS, dim=32, train_cfg=TrainConfig(**FAST),
                  steps_override=10, device="cuda")
    rep = upd.run_once(SyntheticReleaseChannel("go", *_series(1)[0]))
    assert rep.mode == "full"
    counted = len(MODELS) * (GRAPH_WARMUP_STEPS + 1)
    assert tk.launches["kge_score_forward"] == counted
    assert tk.launches["kge_score_backward"] == counted
    for m in MODELS:
        assert rep.details[m]["steps"] == 10
        assert rep.details[m]["graph_replays"] == 10 - GRAPH_WARMUP_STEPS


def test_file_release_channel_matches_the_reference(tmp_path):
    from repro.core.updater import FileReleaseChannel as JaxFileChannel
    from repro_torch.core.updater import FileReleaseChannel
    from repro_torch.ontology import save_obo
    for tag, kg in (("2024-9", _series(1)[0][1]),
                    ("2024-10", _series(2)[1][1])):
        save_obo(kg, tmp_path / f"{tag}.obo", tag)
    got, want = (FileReleaseChannel("go", tmp_path).latest(),
                 JaxFileChannel("go", tmp_path).latest())
    assert got[0] == want[0] == "2024-10"
    assert got[1].checksum() == want[1].checksum()
    with pytest.raises(FileNotFoundError):
        FileReleaseChannel("go", tmp_path / "none").latest()
