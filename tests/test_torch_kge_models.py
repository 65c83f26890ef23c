"""The port's TransR, HolE, BoxE and RDF2vec (with the walk corpus)
against the JAX package's, on the CPU.

Params come from the reference's ``init`` and cross with
``params_from_numpy``; negatives are the reference's draws for a key,
handed to the port's explicit-negatives step; the walks the skip-gram
pairs are cut from are the reference's.  Tolerances: 1e-5 for scores
(fp32 sums in another order, FFTs of another library), 1e-4 for one
step's loss and gradients.  Trained params are compared only through
quality: the two packages draw different random numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.registry import EmbeddingRegistry as JaxRegistry
from repro.core.updater import Updater as JaxUpdater
from repro.data import walks as jwalks
from repro.kge import make_model as jmake_model
from repro.kge import rank_based_eval as jeval
from repro.kge.train import TrainConfig as JaxTrainConfig
from repro.kge.train import make_train_step as jmake_step
from repro.ontology import synthetic as jsyn

from repro_torch.core.registry import EmbeddingRegistry
from repro_torch.core.updater import (PAPER_MODELS, SyntheticReleaseChannel,
                                      Updater)
from repro_torch.data import walks as twalks
from repro_torch.kge import (available_models, make_model, params_from_numpy,
                             params_to_numpy, rank_based_eval, remap_params)
from repro_torch.kge import boxe as tboxe
from repro_torch.kge import transr as ttransr
from repro_torch.kge.train import KGETrainer, TrainConfig, make_train_step
from repro_torch.ontology import synthetic as tsyn
from repro_torch.optim import adam

NEW = ("transr", "hole", "boxe", "rdf2vec")
TOL = 1e-5
GRAD_TOL = 1e-4


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _pair(name, n=50, n_rel=3, dim=16, seed=0):
    """The reference model, the port's, and the reference's init carried
    into the port."""
    jm = jmake_model(name, n, n_rel, dim=dim)
    tm = make_model(name, n, n_rel, dim=dim)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, params_from_numpy(tm, _np(jp), "cpu")


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _jadam():
    from repro.optim import adam as jadam
    return jadam(1e-2)


def _jax_negatives(key, b, n, k):
    """The draws of ``repro.kge.negatives.corrupt`` for ``key``."""
    k_rand, k_side = jax.random.split(key)
    return (np.array(jax.random.randint(k_rand, (b, k), 0, n)),
            np.array(jax.random.bernoulli(k_side, 0.5, (b, k))))


# ------------------------------- models -------------------------------- #
def test_the_paper_six_are_registered():
    assert available_models() == tuple(sorted(PAPER_MODELS))
    with pytest.raises(KeyError, match="nope"):
        make_model("nope", 4, 2)


@pytest.mark.parametrize("name", NEW)
def test_param_shapes_and_roles_match(name):
    jm, tm, jp, tp = _pair(name, n=20, n_rel=4)
    assert {k: tuple(v.shape) for k, v in tp.items()} \
        == {k: tuple(v.shape) for k, v in jp.items()} == tm.param_shapes()
    assert tm.param_roles() == jm.param_roles()
    assert tm.kge_score_model is None             # scored by model.score
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == tm.param_shapes()
    assert all(bool(torch.isfinite(v).all()) for v in fresh.values())
    back = params_to_numpy(tp)
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))


@pytest.mark.parametrize("n_rel", [1, 3, 20])
@pytest.mark.parametrize("name", NEW)
def test_scores_match(name, n_rel):
    """``score`` on broadcast (B, K) ids and both ``score_all_*`` on (B,)
    ids.  TransR at 1, 3 and 20 relations takes both projection paths."""
    jm, tm, jp, tp = _pair(name, n_rel=n_rel)
    rng = np.random.default_rng(n_rel)
    h, t = rng.integers(0, 50, (2, 9, 4))
    r = rng.integers(0, n_rel, (9, 4))
    _close(tm.score(tp, *_t(h, r, t)),
           jm.score(jp, *map(jnp.asarray, (h, r, t))))
    _close(tm.score(tp, *_t(h[:, :1], r[:, :1], t)),
           jm.score(jp, *map(jnp.asarray, (h[:, :1], r[:, :1], t))))
    hb, rb, tb = h[:, 0], r[:, 0], t[:, 0]
    _close(tm.score_all_tails(tp, *_t(hb, rb)),
           jm.score_all_tails(jp, jnp.asarray(hb), jnp.asarray(rb)))
    _close(tm.score_all_heads(tp, *_t(rb, tb)),
           jm.score_all_heads(jp, jnp.asarray(rb), jnp.asarray(tb)))


@pytest.mark.parametrize("name,module", [("transr", ttransr),
                                         ("boxe", tboxe)])
def test_score_all_across_a_chunk_boundary(name, module, monkeypatch):
    """Chunks of 5 entity rows (ragged: 37 rows) give the reference's
    unchunked (B, N, d) answer."""
    jm, tm, jp, tp = _pair(name, n=37)
    h, r = np.array([0, 5, 36]), np.array([0, 1, 2])
    monkeypatch.setattr(module, "SCORE_ALL_ELEMENTS", 3 * 16 * 5)
    _close(tm.score_all_tails(tp, *_t(h, r)),
           jm.score_all_tails(jp, jnp.asarray(h), jnp.asarray(r)))
    _close(tm.score_all_heads(tp, *_t(r, h)),
           jm.score_all_heads(jp, jnp.asarray(r), jnp.asarray(h)))


@pytest.mark.parametrize("name", NEW)
def test_constrain_matches(name):
    jm, tm, jp, tp = _pair(name)
    jp = {k: v * 3.0 for k, v in jp.items()}           # norms well above 1
    tp = params_from_numpy(tm, _np(jp), "cpu")
    assert tm.constrain(tp) is tp                        # in place
    for k, v in jm.constrain(jp).items():
        _close(tp[k], v, 1e-6)


@pytest.mark.parametrize("name", NEW)
def test_rank_based_eval_matches(name):
    kg = jsyn.generate(jsyn.GO_SPEC, seed=5, n_terms=90)
    jm, tm, jp, tp = _pair(name, n=kg.num_entities, n_rel=kg.num_relations)
    ev = kg.triples[:40]
    want = jeval(jm, jp, ev, kg.triples, batch_size=16)
    got = rank_based_eval(tm, tp, ev, kg.triples, batch_size=16)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-4), key


# ----------------------------- one step -------------------------------- #
@pytest.mark.parametrize("name", NEW)
def test_one_training_step_matches_jax_grad(name):
    """Same params, batch and negatives: the loss and every table's
    gradient within 1e-4 of ``jax.grad`` of the reference's loss.  Then
    Adam and the constraint on the reference's gradients keep the params
    on the reference's (1e-5), and the next step starts from there."""
    n, dim, b, k = 40, 16, 32, 6
    jm, tm, jp, tp = _pair(name, n=n, dim=dim)
    trips = np.random.default_rng(3).integers(0, [n, 3, n], (90, 3))
    jcfg = JaxTrainConfig(batch_size=b, num_negs=k)
    tcfg = TrainConfig(batch_size=b, num_negs=k)
    jopt, topt = _jadam(), adam(tcfg.lr)
    jstep, jloss_of = jmake_step(jm, jopt, jcfg)
    tstep = make_train_step(tm, topt, tcfg)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(2):
        batch = trips[i * b:(i + 1) * b]
        key = jax.random.key(20 + i)
        rand, ch = _jax_negatives(key, b, n, k)
        jl, jg = jax.value_and_grad(jloss_of)(jp, jnp.asarray(batch), key)
        tl, tg = tstep.loss_and_grads(tp, torch.from_numpy(batch).long(),
                                      torch.from_numpy(rand).long(),
                                      torch.from_numpy(ch))
        _close(tl, jl, GRAD_TOL)
        assert set(tg) == set(jg)
        for p in jg:
            _close(tg[p], jg[p], GRAD_TOL)
        jp, js, _ = jstep(jp, js, jnp.asarray(batch), key)
        topt.update({p: torch.from_numpy(np.array(g))
                     for p, g in jg.items()}, ts, tp)
        tm.constrain(tp)
        for p in jp:
            _close(tp[p], jp[p])


@pytest.mark.parametrize("name", NEW)
def test_training_reduces_loss(name, tiny_go):
    """As ``tests/test_kge_models.py`` holds the reference: 60 steps from
    the port's own init lower the loss of a fixed batch."""
    kg = tiny_go
    m = make_model(name, kg.num_entities, max(kg.num_relations, 1), dim=16)
    cfg = TrainConfig(batch_size=64, num_negs=8, lr=5e-2, epochs=1, seed=3)
    trainer = KGETrainer(m, cfg, device="cpu")
    params, opt_state = trainer.init()
    batch = torch.from_numpy(kg.triples[:64]).long()
    rand, ch = (torch.from_numpy(x) for x in
                _jax_negatives(jax.random.key(0), 64, kg.num_entities, 8))
    first = float(trainer.train_step.loss_and_grads(
        params, batch, rand.long(), ch)[0])
    params, _, _ = trainer.fit(kg.triples, params=params,
                               opt_state=opt_state, steps=60)
    last = float(trainer.train_step.loss_and_grads(
        params, batch, rand.long(), ch)[0])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, (name, first, last)


@pytest.mark.parametrize("name", NEW)
def test_remap_params_carries_rows_as_the_reference(name):
    from repro.kge import remap_params as jremap
    n_old, n_new, n_rel, dim = 12, 13, 3, 8
    prev = _np(jmake_model(name, n_old, n_rel, dim=dim).init(
        jax.random.key(0)))
    e_map = np.asarray([1, 2, 3, 4, -1, 5, 6, 7, 8, 9, 10, 11, -1], np.int32)
    r_map = np.asarray([0, 2, -1], np.int32)
    jnew = jmake_model(name, n_new, n_rel, dim=dim)
    tnew = make_model(name, n_new, n_rel, dim=dim)
    want, want_stats = jremap(jnew, jax.random.key(1), prev, e_map, r_map)
    got, stats = remap_params(tnew, torch.Generator().manual_seed(1), prev,
                              e_map, r_map)
    assert stats == want_stats
    roles = tnew.param_roles()
    for table, role in roles.items():
        mapping = e_map if role == "entity" else r_map
        keep = mapping >= 0
        np.testing.assert_array_equal(got[table].numpy()[keep],
                                      np.asarray(want[table])[keep])


# ------------------------------- walks --------------------------------- #
def _walk_graph(n_terms=150, seed=4):
    return (jsyn.generate(jsyn.GO_SPEC, seed=seed, n_terms=n_terms),
            tsyn.generate(tsyn.GO_SPEC, seed=seed, n_terms=n_terms))


@pytest.mark.parametrize("add_inverse", [True, False])
def test_port_walks_follow_edges_of_the_graph(add_inverse):
    """Every (entity, relation token, entity) step of a port walk is an
    edge of the graph (inverse edges as their own relation tokens), or a
    dead end's self-loop with the PAD token."""
    _, kg = _walk_graph()
    walks, vocab, pad = twalks.corpus(
        kg, torch.Generator().manual_seed(3), walks_per_entity=3,
        walk_length=4, add_inverse=add_inverse)
    n, r = kg.num_entities, kg.num_relations
    assert walks.shape == (3 * n, 9) and walks.dtype == np.int32
    assert pad == n + (2 * r if add_inverse else r) and vocab == pad + 1
    np.testing.assert_array_equal(walks[:, 0], np.tile(np.arange(n), 3))
    edges = {(int(h), int(n + rel), int(t)) for h, rel, t in kg.triples}
    if add_inverse:
        edges |= {(int(t), int(n + r + rel), int(h))
                  for h, rel, t in kg.triples}
    out_deg = np.bincount(kg.triples[:, 0], minlength=n)
    if add_inverse:
        out_deg = out_deg + np.bincount(kg.triples[:, 2], minlength=n)
    for row in walks:
        for s in range(4):
            a, tok, b = (int(x) for x in row[2 * s:2 * s + 3])
            if tok == pad:
                assert a == b and out_deg[a] == 0
            else:
                assert (a, tok, b) in edges, (a, tok, b)


def test_walk_vocab_and_corpus_shape_match_the_reference():
    jkg, kg = _walk_graph()
    assert twalks.token_vocab(kg) == jwalks.token_vocab(jkg)
    assert twalks.token_vocab(kg, False) == jwalks.token_vocab(jkg, False)
    jw, jv, jpad = jwalks.corpus(jkg, jax.random.key(0), 2, 3)
    tw, tv, tpad = twalks.corpus(kg, torch.Generator().manual_seed(0), 2, 3)
    assert (tw.shape, tv, tpad) == (jw.shape, jv, jpad)
    assert twalks.relation_token(5, 2) == int(jwalks.relation_token(5, 2))


@pytest.mark.parametrize("window", [1, 2, 3])
def test_skipgram_pairs_equal_the_reference_on_its_walks(window):
    jkg, _ = _walk_graph()
    walks, _, pad = jwalks.corpus(jkg, jax.random.key(1), 3, 4)
    walks = np.array(walks)
    walks[::7, 3] = pad                      # PAD tokens are filtered out
    got = twalks.skipgram_pairs(walks, window, pad, seed=5)
    want = jwalks.skipgram_pairs(walks, window, pad, seed=5)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_rdf2vec_step_on_the_reference_pairs_matches_jax_grad():
    """RDF2vec as the updater trains it: (center, 0, context) pairs of
    the reference's walks, over the token vocabulary."""
    jkg, _ = _walk_graph(n_terms=80)
    walks, vocab, pad = jwalks.corpus(jkg, jax.random.key(2), 2, 4)
    pairs = jwalks.skipgram_pairs(np.asarray(walks), 2, pad, seed=0)[:48]
    trips = np.stack([pairs[:, 0], np.zeros(len(pairs), np.int32),
                      pairs[:, 1]], axis=1)
    jm, tm, jp, tp = _pair("rdf2vec", n=vocab, n_rel=1)
    # the reference's w_out starts at zero: move it so every term counts
    jp = {**jp, "context": jp["entity"][::-1] * 0.5}
    tp = params_from_numpy(tm, _np(jp), "cpu")
    cfg = TrainConfig(batch_size=48, num_negs=5)
    _, jloss_of = jmake_step(jm, _jadam(), JaxTrainConfig(batch_size=48,
                                                          num_negs=5))
    key = jax.random.key(9)
    rand, ch = _jax_negatives(key, 48, vocab, 5)
    jl, jg = jax.value_and_grad(jloss_of)(jp, jnp.asarray(trips), key)
    tl, tg = make_train_step(tm, adam(cfg.lr), cfg).loss_and_grads(
        tp, torch.from_numpy(trips).long(), torch.from_numpy(rand).long(),
        torch.from_numpy(ch))
    _close(tl, jl, GRAD_TOL)
    for p in jg:
        _close(tg[p], jg[p], GRAD_TOL)


# ------------------------------ updater -------------------------------- #
FAST = dict(batch_size=64, num_negs=4, lr=5e-2)


def test_six_model_update_publishes_all_six(tmp_path):
    """``Updater.run_once`` with the paper's six models on the CPU: every
    model published, RDF2vec's served rows are the graph's entities, the
    version sealed; an evolved release then warm-starts all six."""
    series = tsyn.release_series(tsyn.GO_SPEC, 2, seed=2, n_terms=90,
                                 add_frac=0.02, obsolete_frac=0.005,
                                 rewire_frac=0.005)
    reg = EmbeddingRegistry(tmp_path)
    upd = Updater(reg, dim=8, train_cfg=TrainConfig(**FAST),
                  steps_override=6, walks_per_entity=2, walk_length=3,
                  device="cpu")
    assert upd.models == PAPER_MODELS
    ch = SyntheticReleaseChannel("go", *series[0])
    rep = upd.run_once(ch)
    kg = series[0][1]
    assert rep.mode == "full" and rep.trained_models == list(PAPER_MODELS)
    assert sorted(reg.models("go")) == sorted(PAPER_MODELS)
    assert reg.store.sealed_versions("go") == [series[0][0]]
    for m in PAPER_MODELS:
        table, _, header = reg.store.open_table("go", series[0][0], m)
        assert np.asarray(table).shape == (kg.num_entities, 8)
        assert header["ids"] == list(kg.entities)
        assert np.isfinite(rep.details[m]["final_loss"])
    params, vocab = reg.get_params("go", "rdf2vec", series[0][0])
    assert vocab["entity"] == twalks.token_vocab(kg)
    assert params["entity"].shape[0] == len(vocab["entity"])
    assert rep.details["rdf2vec"]["steps"] == 6
    ch.bump(*series[1])
    rep2 = upd.run_once(ch, seed=1)
    assert rep2.mode == "incremental"
    assert all(d["mode"] == "incremental" for d in rep2.details.values())


def test_six_models_warm_start_from_the_reference_store(tmp_path):
    """A registry the reference published with all six models is what
    the port updates: its incremental v2 carries every model's rows."""
    jseries = jsyn.release_series(jsyn.GO_SPEC, 2, seed=3, n_terms=70,
                                  add_frac=0.02, obsolete_frac=0.005,
                                  rewire_frac=0.005)
    from repro.core.updater import SyntheticReleaseChannel as JaxChannel
    JaxUpdater(JaxRegistry(tmp_path), dim=8,
               train_cfg=JaxTrainConfig(**FAST), steps_override=3,
               walks_per_entity=2, walk_length=3).run_once(
        JaxChannel("go", *jseries[0]))
    tseries = tsyn.release_series(tsyn.GO_SPEC, 2, seed=3, n_terms=70,
                                  add_frac=0.02, obsolete_frac=0.005,
                                  rewire_frac=0.005)
    upd = Updater(EmbeddingRegistry(tmp_path), dim=8,
                  train_cfg=TrainConfig(**FAST), steps_override=3,
                  walks_per_entity=2, walk_length=3, device="cpu")
    rep = upd.run_once(SyntheticReleaseChannel("go", *tseries[1]))
    assert rep.mode == "incremental"
    for m in PAPER_MODELS:
        assert rep.details[m]["mode"] == "incremental", m
        assert rep.details[m]["carried_rows"] > 0, m
