"""The port's dense-LM training against the JAX package's.

fp32 ``REDUCED`` configs in both packages (``cfg.with_(dtype="float32")``,
as ``tests/test_arch_consistency.py`` runs them): the reference's params,
drawn from its key, are carried into the port by
``models.convert.params_from_numpy``, and the same token ids and labels
(some -1), made by numpy from a seed, go through both.  h2o-danube's
sliding-window layers and qwen2's full causal attention (a window over
every key) run the plain SWA forward and backward here (the kernels'
contract); one Adam step of reduced olmoe-1b-7b and grok-1-314b too
(their loss adds 0.01 times the MoE's aux loss).

Tolerances: the loss within 1e-5 relative; each gradient leaf within
2e-4 * max|g_ref| of the leaf (fp32 sums in another order, through up to
two layers and the softmax); after one Adam step at lr 1e-3, mu within
the grads' tolerance scaled by 0.1 (mu = 0.1 g) and nu within 4e-4 *
max|nu_ref| (nu = 1e-3 g^2: the grads' relative tolerance, doubled by
the square), the params within 1e-5 wherever |g_ref| > 1e-3 * max|g_ref|
of the leaf, and everywhere moved by at most lr * (1 + 1e-3): Adam's
first step moves each element by about lr * sign(g), so a gradient near
zero may take either sign in the two packages (ROADMAP Queue 3, item 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as jbuild
from repro.models import get_config as jget_config
from repro.models.lm import xent as jxent
from repro.models.steps import make_train_step as jmake_train_step
from repro_torch.kernels import swa_attention as tswa
from repro_torch.launch import train as tlaunch
from repro_torch.models import build, get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import xent
from repro_torch.models.steps import make_train_step

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # times max|g_ref| of the leaf
PARAM_TOL = 1e-5
LR = 1e-3

#: (arch, B, S, params key): h2o-danube past and within its reduced window
#: of 64, and qwen2 (full causal attention, QKV bias)
CASES = [("h2o_danube_1_8b", 2, 96, 1), ("h2o_danube_1_8b", 2, 48, 2),
         ("qwen2_72b", 2, 40, 3)]
#: the MoE archs' one Adam step: reduced olmoe-1b-7b and grok-1-314b
#: (causal attention, cross-entropy + 0.01 times the aux loss)
MOE_CASES = [("olmoe_1b_7b", 2, 40, 5), ("grok_1_314b", 2, 40, 6)]


def _case_id(c):
    return f"{c[0]}-B{c[1]}-S{c[2]}"


def _cfgs(arch, remat="full"):
    return (jget_config(arch, reduced=True).with_(dtype="float32",
                                                  remat=remat),
            get_config(arch, reduced=True).with_(dtype="float32",
                                                 remat=remat))


def _batch(vocab, B, S, seed):
    """Token ids and labels, with a few labels -1 (ignored)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.1] = -1
    return toks, labels


def _flat_ref(tree, n_layers):
    """The reference's pytree as the port's dotted leaves: each stacked
    layer leaf ``(L, ...)`` split into ``layers.i.<path>``; with each leaf
    the whole reference leaf it came from (the scale of its tolerance)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        a = np.asarray(node, np.float32)
        if path[0] == "layers":
            for i in range(n_layers):
                out[".".join(("layers", str(i)) + path[1:])] = (a[i], a)
        else:
            out[".".join(path)] = (a, a)

    walk(tree, ())
    return out


def _port_model(arch, key, remat="full"):
    jcfg, tcfg = _cfgs(arch, remat)
    params = jbuild(jcfg).init(jax.random.key(key))
    model = params_from_numpy(build(tcfg), jax.tree.map(np.asarray, params),
                              "cpu")
    return jcfg, tcfg, params, model


def _port_loss_and_grads(model, toks, labels):
    model.params.requires_grad_(True)
    for p in model.params.parameters():
        p.grad = None
    loss, metrics = model.loss({"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
    loss.backward()
    grads = {n: p.grad.numpy().copy()
             for n, p in model.params.named_parameters()}
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, grads)


_REF: dict = {}


def _ref_loss_and_grads(case):
    """``jax.value_and_grad(model.loss)`` of the reference, once a case."""
    if case in _REF:
        return _REF[case]
    arch, B, S, key = case
    jcfg, _ = _cfgs(arch)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(key))
    toks, labels = _batch(jcfg.vocab, B, S, seed=S + key)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    _REF[case] = (float(loss), {k: float(v) for k, v in metrics.items()},
                  _flat_ref(jax.tree.map(np.asarray, grads), jcfg.n_layers))
    return _REF[case]


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, (g_ref, leaf) in want.items():
        tol = GRAD_TOL * max(float(np.abs(leaf).max()), 1e-30)
        err = float(np.abs(got[name] - g_ref).max())
        assert err <= tol, f"{name}: off by {err}, tolerance {tol}"


# ------------------------------- xent --------------------------------- #
@pytest.mark.parametrize("ignored", [0.0, 0.3, 1.0])
def test_xent_matches_jax(ignored):
    """Loss and accuracy with label -1 ignored; all ignored gives 0."""
    rng = np.random.default_rng(int(ignored * 10))
    logits = (rng.standard_normal((2, 9, 37)) * 3).astype(np.float32)
    labels = rng.integers(0, 37, (2, 9)).astype(np.int32)
    labels[:, :3] = logits[:, :3].argmax(-1)          # some correct
    labels[rng.random((2, 9)) < ignored] = -1
    want = jxent(jnp.asarray(logits), jnp.asarray(labels))
    got = xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6,
                               atol=1e-6)
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-7)


def test_xent_casts_low_precision_logits_to_fp32():
    logits = torch.randn(1, 4, 16, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, 2, 3, -1]])
    lo = xent(logits.to(torch.bfloat16), labels)
    hi = xent(logits.to(torch.bfloat16).float(), labels)
    assert lo[0].dtype == torch.float32 and torch.equal(lo[0], hi[0])


# ------------------------ loss and gradients -------------------------- #
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_loss_and_grads_match_jax(case):
    arch, B, S, key = case
    want_loss, want_metrics, want_grads = _ref_loss_and_grads(case)
    jcfg, tcfg, _, model = _port_model(arch, key)
    toks, labels = _batch(tcfg.vocab, B, S, seed=S + key)
    loss, metrics, grads = _port_loss_and_grads(model, toks, labels)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert metrics["ce"] == pytest.approx(want_metrics["ce"], rel=LOSS_RTOL)
    assert metrics["aux"] == want_metrics["aux"] == 0.0
    assert metrics["acc"] == pytest.approx(want_metrics["acc"], abs=1e-7)
    _assert_grads_close(grads, want_grads)


def test_the_window_case_runs_past_the_window():
    """The first case's S exceeds reduced h2o-danube's window, the second's
    does not: both sides of the band are held to the reference."""
    W = get_config("h2o_danube_1_8b", reduced=True).window
    assert CASES[0][2] > W > CASES[1][2]


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_loss_and_grads(remat):
    """``"full"``, ``"none"`` and ``"dots"`` (the dense projections saved)
    compute the same function: the same loss and gradients bit for bit."""
    case = CASES[0]
    arch, B, S, key = case
    runs = {}
    for r in ("full", remat):
        _, tcfg, _, model = _port_model(arch, key, remat=r)
        toks, labels = _batch(tcfg.vocab, B, S, seed=S + key)
        runs[r] = _port_loss_and_grads(model, toks, labels)
    assert runs[remat][0] == runs["full"][0]
    for name, g in runs["full"][2].items():
        np.testing.assert_array_equal(runs[remat][2][name], g, err_msg=name)


def test_grad_reaches_every_param_and_prefill_stays_frozen():
    """Training turns every leaf's gradient on; a model that never trained
    serves with frozen leaves and builds no graph."""
    _, tcfg, _, model = _port_model("h2o_danube_1_8b", 1)
    assert not any(p.requires_grad for p in model.params.parameters())
    logits, _ = model.prefill({"tokens": torch.zeros((1, 8),
                                                     dtype=torch.int32)})
    assert logits.grad_fn is None
    toks, labels = _batch(tcfg.vocab, 1, 70, seed=0)
    _, _, grads = _port_loss_and_grads(model, toks, labels)
    assert all(np.abs(g).max() > 0 for g in grads.values())


# ------------------------------ one step ------------------------------ #
@pytest.mark.parametrize("case", [CASES[0], CASES[2], *MOE_CASES],
                         ids=_case_id)
def test_one_train_step_matches_jax(case):
    arch, B, S, key = case
    jcfg, tcfg, params, model = _port_model(arch, key)
    toks, labels = _batch(tcfg.vocab, B, S, seed=S + key)
    jstep, jopt = jmake_train_step(jbuild(jcfg), lr=LR)
    jparams, jstate, jmetrics = jax.jit(jstep)(
        params, jopt.init(params), {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
    n_layers = jcfg.n_layers
    before = {n: p.detach().clone().numpy()
              for n, p in model.params.named_parameters()}
    step, opt = make_train_step(model, lr=LR)
    state = opt.init(dict(model.params.named_parameters()))
    state, metrics = step(state, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert state.step == int(jstate.step) == 1
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=LOSS_RTOL)
    grads = _ref_loss_and_grads(case)[2]
    mu = _flat_ref(jax.tree.map(np.asarray, jstate.mu), n_layers)
    nu = _flat_ref(jax.tree.map(np.asarray, jstate.nu), n_layers)
    new = _flat_ref(jax.tree.map(np.asarray, jparams), n_layers)
    for name, p in model.params.named_parameters():
        m_ref, m_leaf = mu[name]
        v_ref, v_leaf = nu[name]
        assert np.abs(state.mu[name].numpy() - m_ref).max() \
            <= GRAD_TOL * np.abs(m_leaf).max(), name
        assert np.abs(state.nu[name].numpy() - v_ref).max() \
            <= 2 * GRAD_TOL * np.abs(v_leaf).max(), name
        g_ref, g_leaf = grads[name]
        firm = np.abs(g_ref) > 1e-3 * np.abs(g_leaf).max()
        got = p.detach().numpy()
        np.testing.assert_allclose(got[firm], new[name][0][firm],
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=name)
        assert np.abs(got - before[name]).max() <= LR * (1 + 1e-3), name
        assert p.grad is None                      # freed after the update


def test_loss_falls_on_a_repeated_batch():
    """A sanity check of the gradient's sign: four steps on one batch."""
    _, tcfg, _, model = _port_model("h2o_danube_1_8b", 4)
    toks, labels = _batch(tcfg.vocab, 2, 80, seed=4)
    step, opt = make_train_step(model, lr=LR)
    state = opt.init(dict(model.params.named_parameters()))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


# ------------------------------ launcher ------------------------------ #
def _ref_first_loss(arch, batch, seq, seed):
    """The first step's loss of ``repro.launch.train.train_lm`` in fp32:
    params from ``jax.random.key(seed)``, then tokens and labels drawn from
    ``np.random.default_rng(seed)`` in its order; the loss is read before
    the update."""
    jcfg = jget_config(arch, reduced=True).with_(dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    b = {k: jnp.asarray(rng.integers(0, jcfg.vocab, v.shape), jnp.int32)
         for k, v in jm.batch_spec(batch, seq).items()}
    return params, float(jm.loss(params, b)[0])


def test_launch_train_lm_first_loss_matches_reference(monkeypatch, capsys):
    """``launch.train``'s LM mode on reduced h2o-danube in fp32 (the config
    module's ``REDUCED`` swapped for its fp32 copy: the zoo reads it at
    call time), from the reference's params: its first loss is
    ``train_lm``'s first-step loss on the same seed."""
    from repro_torch.configs import h2o_danube_1_8b as cfg_mod
    monkeypatch.setattr(cfg_mod, "REDUCED",
                        cfg_mod.REDUCED.with_(dtype="float32"))
    params, want = _ref_first_loss("h2o-danube-1.8b", 4, 128, 0)
    out = tlaunch.train_lm("h2o-danube-1.8b", reduced=True, steps=3,
                           batch=4, seq=128, seed=0, device="cpu",
                           params=jax.tree.map(np.asarray, params))
    assert out["dtype"] == "float32"
    assert out["losses"][0] == pytest.approx(want, rel=LOSS_RTOL)
    assert len(out["losses"]) == len(out["step_ms"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert out["seq"] == 128 > get_config("h2o-danube-1.8b", True).window
    assert out["peak_mem_bytes"] is None            # no device memory here
    assert set(out["swa_launches"].values()) == {0}  # the plain versions
    text = capsys.readouterr().out
    assert "step    0 loss=" in text and "tok/s" in text


def test_launch_train_lm_runs_from_its_seed():
    """The command line: the reduced bf16 config trains from the seed, and
    the same seed gives the same losses."""
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "80", "--device", "cpu"]
    a, b = tlaunch.main(argv), tlaunch.main(argv)
    assert a["dtype"] == "bfloat16" and a["losses"] == b["losses"]
    assert all(np.isfinite(a["losses"]))


@pytest.mark.parametrize("argv", [[], ["--workload", "go", "--arch",
                                       "h2o-danube-1.8b"]])
def test_launch_train_wants_exactly_one_mode(argv):
    with pytest.raises(SystemExit):
        tlaunch.main(argv + ["--device", "cpu"])


def test_launch_train_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps",
                      "1"])


# ------------------------------ the card ------------------------------ #
@pytest.mark.cuda
def test_train_step_runs_the_kernels_on_card():
    """Reduced h2o-danube in fp32 on the card: the loss and gradients of
    the kernels' step against the CPU plain step (2e-4 * max|g| a leaf),
    and per layer two SWA forwards (the step and its recompute) and one
    launch of each backward entry point; skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    arch, B, S, key = CASES[0]
    jcfg, tcfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(key)))
    toks, labels = _batch(tcfg.vocab, B, S, seed=S + key)
    cpu = _port_loss_and_grads(params_from_numpy(build(tcfg), params, "cpu"),
                               toks, labels)
    model = params_from_numpy(build(tcfg), params, "cuda")
    model.params.requires_grad_(True)
    tswa.reset_launches()
    loss, _ = model.loss({"tokens": torch.from_numpy(toks).cuda(),
                          "labels": torch.from_numpy(labels).cuda()})
    loss.backward()
    torch.cuda.synchronize()
    L = tcfg.n_layers
    assert tswa.launches == {"swa_attention_forward": 2 * L,
                             "swa_attention_bwd_dot": L,
                             "swa_attention_backward_dkdv": L,
                             "swa_attention_backward_dq": L}
    assert float(loss) == pytest.approx(cpu[0], rel=LOSS_RTOL)
    for name, p in model.params.named_parameters():
        want = cpu[2][name]
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        assert np.abs(p.grad.cpu().numpy() - want).max() <= tol, name
