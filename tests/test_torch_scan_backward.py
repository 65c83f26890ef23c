"""The fused selective scan's gradient in the port, on the CPU.

- ``ref.selective_scan_fused_backward`` (the backward kernel's contract,
  an explicit reverse loop) against ``torch.autograd`` through
  ``ref.selective_scan_fused``, in fp64 (within 1e-12 * max|g| a
  gradient: the same arithmetic in another order) and fp32 (1e-5 *
  max|g|: fp32 sums in another order); d_state 4, 8 and 16, S 1, 15, 16,
  33 and 300 (one 16-step tile, its edges, past one, the reference's
  chunk), from h0 or zeros, from a gradient of h_last or none, with dt +
  bias on both sides of softplus's threshold of 20 and z a strided half of
  a (B, S, 2 d_in) tensor.
- The same gradients against ``jax.vjp`` of the reference's own tail of
  ``mamba_apply`` (``_selective_scan_chunk`` under ``lax.scan``, its
  softplus, D skip and gate) on numpy inputs from a seed, in fp32 within
  2e-5 * max|g_ref| (the reference scans by a log-depth associative scan).
- ``torch.autograd.gradcheck`` of ``SelectiveScanFusedFn`` in fp64.
- ``selective_scan_fused`` goes through the Function exactly when grad is
  enabled and an input asks for one; ``mamba_apply``'s every gradient
  through the Function equals autograd through the plain version (the
  views of in_proj's and x_proj's outputs keep their gradients).
- ``launch.train`` reports the fused scan's launches by entry point.

The kernel against this contract on the card is
``tests/test_torch_scan_fused.py::test_fused_backward_kernel_matches_plain_on_card``
(no JAX there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss
from repro_torch.models import blocks as tblocks
from repro_torch.models.config import ArchConfig, SSMConfig

#: the plain backward against autograd: a gradient within TOL * max|g|
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
#: against the reference's associative scan, fp32
JAX_TOL = 2e-5
NAMES = ("h0", "dt", "Bm", "Cm", "A", "xc", "D", "z", "dt_bias")


def _inputs(B, S, d_in, st, seed, dtype, h0=True, dh_last=True):
    """``(args, dout, dh_last, leaves)``: the fused scan's arguments as the
    block passes them (Bm | Cm column slices of x_proj's output, z the
    second half of in_proj's), dt + bias around softplus's threshold at
    every 7th value, numpy from a seed; ``leaves`` the tensors that own
    the views (dbc and xz in place of Bm, Cm and z)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    dt = f(B, S, d_in) * 2
    bias = f(d_in) * 0.5
    straddle = torch.arange(dt.numel()) % 7 == 0
    dt.view(-1)[straddle] = torch.where(
        torch.arange(int(straddle.sum())) % 2 == 0, 19.5, 20.5).to(dtype)
    dt = dt - bias                      # dt + bias at 19.5 / 20.5 there
    dbc = f(B, S, 3 + 2 * st)
    xz = f(B, S, 2 * d_in)
    A = -torch.arange(1, st + 1, dtype=dtype).expand(d_in, st) \
        * torch.exp(0.1 * f(d_in, st))
    leaves = {"h0": f(B, d_in, st) if h0 else None, "dt": dt, "dbc": dbc,
              "A": A.contiguous(), "xc": f(B, S, d_in), "D": f(d_in),
              "xz": xz, "dt_bias": bias}
    dout, dhl = f(B, S, d_in), f(B, d_in, st) if dh_last else None
    return leaves, dout, dhl


def _args(leaves, st):
    dbc, xz = leaves["dbc"], leaves["xz"]
    d_in = xz.shape[-1] // 2
    return (leaves["h0"], leaves["dt"], dbc[..., 3:3 + st], dbc[..., 3 + st:],
            leaves["A"], leaves["xc"], leaves["D"], xz[..., d_in:],
            leaves["dt_bias"])


def _autograd(leaves, st, dout, dh_last):
    """Every leaf's gradient by autograd through the plain forward."""
    leaves = {k: None if v is None else v.clone().requires_grad_(True)
              for k, v in leaves.items()}
    h, out = tref.selective_scan_fused(*_args(leaves, st), chunk=16)
    torch.autograd.backward([out] + ([h] if dh_last is not None else []),
                            [dout] + ([dh_last] if dh_last is not None
                                      else []))
    return leaves


def _grads_as_leaves(grads, leaves, st):
    """The backward's per-argument gradients as the leaves' own: dBm | dCm
    into dbc's columns, dz into xz's second half."""
    g = dict(zip(NAMES, grads))
    dbc = torch.zeros_like(leaves["dbc"])
    dbc[..., 3:3 + st], dbc[..., 3 + st:] = g["Bm"], g["Cm"]
    xz = torch.zeros_like(leaves["xz"])
    xz[..., xz.shape[-1] // 2:] = g["z"]
    return {"h0": g["h0"], "dt": g["dt"], "dbc": dbc, "A": g["A"],
            "xc": g["xc"], "D": g["D"], "xz": xz, "dt_bias": g["dt_bias"]}


def _assert_grads(got: dict, want: dict, tol: float):
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        # dA is 0 where no step has a state before it (S 1 from zeros)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("st", [4, 8, 16])
@pytest.mark.parametrize("S", [1, 15, 16, 33, 300])
@pytest.mark.parametrize("start", ["zero", "h0", "dh_last", "both"])
def test_plain_backward_matches_autograd(dtype, st, S, start):
    leaves, dout, dhl = _inputs(2, S, 8, st, seed=S * 10 + st, dtype=dtype,
                                h0=start in ("h0", "both"),
                                dh_last=start in ("dh_last", "both"))
    want = _autograd(leaves, st, dout, dhl)
    grads = tref.selective_scan_fused_backward(*_args(leaves, st), dout, dhl)
    got = _grads_as_leaves(grads, leaves, st)
    _assert_grads(got, {k: None if v is None else v.grad
                        for k, v in want.items()}, TOL[dtype])
    # dtypes: the model's for ddt, dxc, dz, ddt_bias, Bm's for dBm and dCm
    for name, g in zip(NAMES, grads):
        if g is not None:
            assert g.dtype == dtype, name


@pytest.mark.parametrize("L", [4, 8, 16])
@pytest.mark.parametrize("S", [1, 15, 17, 300])
def test_adjoint_split_into_runs_equals_the_stepwise_adjoint(L, S):
    """The algebra the backward kernel's runs rely on, in fp64: the
    adjoint dh_t = C_t g_t + a_{t+1} dh_{t+1} split into runs of L steps,
    each run from a zero adjoint (its decay product cum = prod a over the
    run and its local carry out lc = sum_t cum_t C_t g_t, cum_t the
    product of a up to t) and the runs combined in reverse by those
    pairs (carry in of a run = lc + cum * carry in of the run after it),
    gives every step's dh_t as dh_local_t + (prod of a after t in the
    run) * carry, within 1e-12 * max|dh| of the stepwise adjoint of
    ``ref.selective_scan_fused_backward``; the carry leaving the first
    run is its dh0."""
    st = 16
    leaves, dout, dhl = _inputs(2, S, 8, st, seed=S + L, dtype=torch.float64)
    h0, dt, Bm, Cm, A, xc, D, z, bias = _args(leaves, st)
    dtf = torch.nn.functional.softplus(dt + bias)
    a = torch.exp(dtf[..., None] * A)                      # (B, S, d_in, st)
    cg = Cm[:, :, None, :] * (dout * z * torch.sigmoid(z))[..., None]
    # the stepwise adjoint, as the reference's reverse loop runs it
    step = torch.empty_like(a)
    dh = dhl.clone()
    for t in reversed(range(S)):
        dh = dh + cg[:, t]
        step[:, t] = dh
        dh = a[:, t] * dh
    # the runs, each from a zero adjoint: (cum, lc) and the local dh_t
    runs = [(s, min(s + L, S)) for s in range(0, S, L)]
    local, pairs = torch.empty_like(a), []
    for s, e in runs:
        cum = torch.ones_like(dhl)
        lc = torch.zeros_like(dhl)
        for t in range(s, e):
            cum = cum * a[:, t]
            lc = lc + cum * cg[:, t]
        d = torch.zeros_like(dhl)
        for t in reversed(range(s, e)):
            d = d + cg[:, t]
            local[:, t] = d
            d = a[:, t] * d
        pairs.append((cum, lc))
    # combined in reverse; each step's dh from its run's carry in
    got, carry = torch.empty_like(a), dhl.clone()
    for (s, e), (cum, lc) in reversed(list(zip(runs, pairs))):
        after = torch.ones_like(dhl)                  # prod of a after t
        for t in reversed(range(s, e)):
            got[:, t] = local[:, t] + after * carry
            after = after * a[:, t]
        carry = lc + cum * carry
    scale = float(step.abs().max())
    assert float((got - step).abs().max()) <= 1e-12 * scale
    dh0 = tref.selective_scan_fused_backward(h0, dt, Bm, Cm, A, xc, D, z,
                                             bias, dout, dhl)[0]
    assert float((carry - dh0).abs().max()) <= 1e-12 * float(
        dh0.abs().max())


def test_inputs_straddle_softplus_threshold():
    """The cases above hold dt + bias on both sides of 20, where
    softplus's gradient turns from sigmoid(v) to 1."""
    leaves, _, _ = _inputs(2, 33, 8, 4, seed=2, dtype=torch.float32)
    v = leaves["dt"] + leaves["dt_bias"]
    assert torch.equal(v > 20, v > 20.25) and (v > 20).any()
    assert ((v > 19.25) & (v < 20)).any()


# ------------------------- against the reference ----------------------- #
def _reference_tail(h0, dt, bc, A, xc, D, xz, st, chunk=256):
    """The reference's tail of ``mamba_apply`` (``repro.models.blocks``,
    lines 642-659) from h0: softplus of dt (its bias added) in fp32, the
    scan over zero-padded chunks under ``lax.scan`` with
    ``_selective_scan_chunk``, the D skip, the silu(z) gate."""
    d_in = xc.shape[-1]
    Bm, Cm, z = bc[..., :st], bc[..., st:], xz[..., d_in:]
    dt = jax.nn.softplus(dt.astype(jnp.float32))
    B, S, _ = xc.shape
    c = min(chunk, S)
    pad = -S % c
    padded = [jnp.pad(a, ((0, 0), (0, pad), (0, 0)))
              for a in (dt, Bm, Cm, xc)]
    n = padded[0].shape[1] // c
    reshape = lambda a: jnp.moveaxis(a.reshape(B, n, c, -1), 1, 0)

    def step(h, inp):
        dt_i, B_i, C_i, x_i = inp
        return jblocks._selective_scan_chunk(h, dt_i, B_i, C_i, A, x_i)

    h, ys = jax.lax.scan(step, h0, tuple(map(reshape, padded)))
    y = jnp.moveaxis(ys, 0, 1).reshape(B, n * c, d_in)[:, :S]
    y = y + D * xc.astype(jnp.float32)
    return h, (y * jax.nn.silu(z.astype(jnp.float32))).astype(xc.dtype)


@pytest.mark.parametrize("st", [4, 8])
@pytest.mark.parametrize("S", [24, 300, 1])
@pytest.mark.parametrize("h0_zero", [True, False])
def test_plain_backward_matches_the_references_vjp(st, S, h0_zero):
    """``jax.vjp`` of the reference's tail, with dt_proj's bias added
    before it as the reference's ``dense`` adds it (so ddt_bias is its
    dt cotangent summed over (b, t)), against the plain backward; z and
    Bm | Cm cut from one tensor each on both sides."""
    B, d_in = 2, 64
    rng = np.random.default_rng(S * 10 + st + h0_zero)
    f = lambda *sh: rng.standard_normal(sh, dtype=np.float32)
    h0 = np.zeros((B, d_in, st), np.float32) if h0_zero else f(B, d_in, st)
    dt, xc, D = f(B, S, d_in) * 2, f(B, S, d_in), f(d_in)
    bc, xz = f(B, S, 2 * st), f(B, S, 2 * d_in)
    A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (d_in, 1)) \
        * np.exp(0.1 * f(d_in, st))
    bias = f(d_in) * 0.5
    dout, dh_last = f(B, S, d_in), f(B, d_in, st)
    (jh, jout), vjp = jax.vjp(
        lambda *a: _reference_tail(*a, st=st),
        *map(jnp.asarray, (h0, dt + bias, bc, A, xc, D, xz)))
    jg = dict(zip(("h0", "dt", "bc", "A", "xc", "D", "xz"), map(
        np.asarray, vjp((jnp.asarray(dh_last), jnp.asarray(dout))))))
    t = torch.from_numpy
    tbc, txz = t(bc), t(xz)
    g = dict(zip(NAMES, tref.selective_scan_fused_backward(
        None if h0_zero else t(h0), t(dt), tbc[..., :st], tbc[..., st:],
        t(A), t(xc), t(D), txz[..., d_in:], t(bias), t(dout), t(dh_last))))
    got = {"dt": g["dt"], "bc": torch.cat([g["Bm"], g["Cm"]], -1),
           "A": g["A"], "xc": g["xc"], "D": g["D"],
           "xz": torch.cat([torch.zeros_like(g["z"]), g["z"]], -1)}
    if not h0_zero:
        got["h0"] = g["h0"]
    else:
        assert g["h0"] is None
    for name, want in got.items():
        ref = jg[name]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(want.numpy(), ref, rtol=0,
                                   atol=JAX_TOL * scale, err_msg=name)
    # ddt_bias: the reference's dt cotangent summed over (b, t)
    np.testing.assert_allclose(g["dt_bias"].numpy(), jg["dt"].sum((0, 1)),
                               rtol=0, atol=JAX_TOL * np.abs(
                                   jg["dt"].sum((0, 1))).max())


# ------------------------------ the Function --------------------------- #
@pytest.mark.parametrize("h0", [True, False])
def test_function_passes_gradcheck_in_fp64(h0):
    leaves, _, _ = _inputs(1, 5, 4, 4, seed=7, dtype=torch.float64, h0=h0)
    leaves["dt"] = leaves["dt"] * 0.1           # off softplus's kink
    args = [None if a is None else a.clone().requires_grad_(True)
            for a in _args(leaves, 4)]
    args[2], args[3], args[7] = (args[i].detach().contiguous()
                                 .requires_grad_(True) for i in (2, 3, 7))

    def fn(*a):
        return tss.SelectiveScanFusedFn.apply(*a, 3)

    assert torch.autograd.gradcheck(fn, tuple(args), eps=1e-6, atol=1e-7,
                                    rtol=1e-6)


def test_wrapper_goes_through_the_function_only_with_a_gradient(monkeypatch):
    seen = []
    real = tss.SelectiveScanFusedFn.apply
    monkeypatch.setattr(tss.SelectiveScanFusedFn, "apply",
                        lambda *a: seen.append(1) or real(*a))
    leaves, _, _ = _inputs(2, 20, 8, 4, seed=8, dtype=torch.float32)
    args = list(_args(leaves, 4))
    h, out = tss.selective_scan_fused(*args)
    assert not seen and not out.requires_grad
    args[5] = args[5].clone().requires_grad_(True)
    with torch.no_grad():
        tss.selective_scan_fused(*args)
    assert not seen
    h2, out2 = tss.selective_scan_fused(*args)
    assert seen == [1] and out2.requires_grad and h2.requires_grad
    assert torch.equal(h, h2) and torch.equal(out, out2)


def test_function_takes_no_gradient_of_h_last_or_of_out():
    """Training reads only ``out``: the gradient of h_last reaches the
    backward as None (zero); one of ``out`` alone is honoured too."""
    leaves, dout, dhl = _inputs(1, 18, 8, 8, seed=9, dtype=torch.float64)
    args = [None if a is None else a.clone().requires_grad_(True)
            for a in _args(leaves, 8)]
    h, out = tss.selective_scan_fused(*args)
    (gx,) = torch.autograd.grad(out, [args[5]], dout, retain_graph=True)
    want = tref.selective_scan_fused_backward(*[
        None if a is None else a.detach() for a in args], dout)[5]
    assert torch.equal(gx, want)
    (gx,) = torch.autograd.grad(h, [args[5]], dhl)
    want = tref.selective_scan_fused_backward(*[
        None if a is None else a.detach() for a in args],
        torch.zeros_like(dout), dhl)[5]
    assert torch.equal(gx, want)


@pytest.mark.parametrize("bad", ["dout shape", "dout dtype", "dh_last"])
def test_backward_wrapper_rejects_what_does_not_fit(bad):
    leaves, dout, dhl = _inputs(2, 8, 16, 4, seed=10, dtype=torch.float32)
    dout, dhl = {"dout shape": (dout[:, :4], dhl),
                 "dout dtype": (dout.double(), dhl),
                 "dh_last": (dout, dhl[..., :2])}[bad]
    with pytest.raises(ValueError):
        tss.selective_scan_fused_backward(*_args(leaves, 4), dout, dhl)


def test_mamba_apply_gradients_through_the_function_equal_autograd(
        monkeypatch):
    """Every param's and the input's gradient of one Mamba block, through
    ``SelectiveScanFusedFn`` (the plain backward), against autograd through
    the plain forward: the gradients of Bm, Cm (x_proj's output) and z
    (in_proj's) reach their tensors through the views, within 1e-5 *
    max|g| (fp32 sums in another order)."""
    cfg = ArchConfig(arch_id="ssm-t", family="ssm", n_layers=1, d_model=32,
                     n_heads=0, n_kv_heads=1, d_ff=0, vocab=64,
                     dtype="float32", attention="none",
                     ssm=SSMConfig(d_state=8, d_conv=4, expand=2))
    x0 = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 37, 32), dtype=np.float32))

    def grads():
        p = tblocks.mamba_init(torch.Generator().manual_seed(3), cfg)
        leaves = {"x": x0.clone().requires_grad_(True)}
        for name, sub in p.items():
            if isinstance(sub, dict):
                for k, v in sub.items():
                    leaves[f"{name}.{k}"] = v.requires_grad_(True)
            else:
                leaves[name] = sub.requires_grad_(True)
        y = tblocks.mamba_apply(p, leaves["x"], cfg)
        (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        return {k: v.grad for k, v in leaves.items()}

    through_fn = grads()
    monkeypatch.setattr(tss, "_wants_grad", lambda tensors: False)
    plain = grads()                     # autograd through ref's forward
    assert set(through_fn) == set(plain)
    _assert_grads(through_fn, plain, 1e-5)


def test_launch_train_reports_the_scan_launches_by_entry_point():
    from repro_torch.launch import train
    out = train.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "1", "--seq", "20"])
    assert out["scan_launches"] == {"selective_scan_forward": 0,
                                    "selective_scan_fused": 0,
                                    "selective_scan_fused_backward": 0}
    assert all(np.isfinite(out["losses"]))
