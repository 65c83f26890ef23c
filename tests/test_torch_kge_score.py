"""The port's fused KGE scoring against the JAX package's.

The same inputs, made by numpy from a seed, go through
``repro.kernels.kge_score.kge_score_pallas`` (interpret mode), the JAX
``kge_score_ref`` and ``jax.vjp`` of it, and through the port's plain
forward and backward (what the wrapper runs on a CPU tensor) and its
``torch.autograd.Function``.  Tolerance 1e-4, the reference's own for
KGE scoring (``tests/test_kernels.py``): fp32 sums taken in another
order.  The CUDA kernels run only on a card (the ``cuda`` test at the
end, and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.kge_score import kge_score_pallas
from repro_torch.kernels import kge_score as tkge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

MODELS = ("transe_l1", "transe_l2", "distmult")
#: test_kernels.py's grid, one more d = 200 shape, and the smallest
GRID = [(32, 8, 64), (100, 5, 200), (7, 3, 32), (16, 32, 200), (1, 1, 1)]
TOL = 1e-4


def _inputs(B, K, d, seed=0, mask="random", t_is_h_plus_r=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, d)).astype(np.float32)
    r = rng.standard_normal((B, d)).astype(np.float32)
    t = (h + r) if t_is_h_plus_r else rng.standard_normal((B, d)).astype(np.float32)
    neg = rng.standard_normal((B, K, d)).astype(np.float32)
    ch = {"random": rng.random((B, K)) < 0.5,
          "true": np.ones((B, K), bool),
          "false": np.zeros((B, K), bool)}[mask]
    return h, r, t.astype(np.float32), neg, ch


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("B,K,d", GRID[:3])
def test_forward_matches_pallas_interpret(model, B, K, d):
    h, r, t, neg, ch = _inputs(B, K, d, seed=B + K + d)
    pos_p, negs_p = kge_score_pallas(*map(jnp.asarray, (h, r, t, neg, ch)),
                                     model=model, interpret=True)
    pos, negs = tkge.kge_score_forward(*_t(h, r, t, neg, ch), model)
    _close(pos, pos_p)
    _close(negs, negs_p)


@pytest.mark.parametrize("mask", ["random", "true", "false"])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("B,K,d", GRID)
def test_forward_matches_jax_ref(model, B, K, d, mask):
    h, r, t, neg, ch = _inputs(B, K, d, seed=7, mask=mask)
    want = jref.kge_score_ref(*map(jnp.asarray, (h, r, t, neg, ch)),
                              model=model)
    got = tops.kge_score(*_t(h, r, t, neg, ch), model)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("mask", ["random", "true", "false"])
@pytest.mark.parametrize("t_is_h_plus_r", [False, True])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("B,K,d", GRID)
def test_backward_matches_jax_vjp(model, B, K, d, t_is_h_plus_r, mask):
    """The plain backward against ``jax.vjp`` of the reference with
    random cotangents; ``t = h + r`` makes every coordinate of the
    positive's difference exactly 0, where the derivative of |x| must be
    JAX's +1."""
    h, r, t, neg, ch = _inputs(B, K, d, seed=11, mask=mask,
                               t_is_h_plus_r=t_is_h_plus_r)
    rng = np.random.default_rng(5)
    g_pos = rng.standard_normal(B).astype(np.float32)
    g_negs = rng.standard_normal((B, K)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, n: jref.kge_score_ref(
        a, b, c, n, jnp.asarray(ch), model=model),
        *map(jnp.asarray, (h, r, t, neg)))
    want = vjp((jnp.asarray(g_pos), jnp.asarray(g_negs)))
    got = tkge.kge_score_backward(*_t(h, r, t, neg, ch, g_pos, g_negs), model)
    for name, g, w in zip(("h", "r", "t", "neg"), got, want):
        assert g.shape == w.shape, name
        _close(g, w)


def test_abs_gradient_at_zero_follows_jax():
    """``jax.grad(jnp.abs)(0.0) == 1.0``; ``torch.abs``'s is 0.  With
    ``t = h + r`` and only the positive's cotangent, TransE-L1's gradient
    is exactly ``-g_pos`` in every coordinate of h and r."""
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    h, r, t, neg, ch = _inputs(4, 3, 8, t_is_h_plus_r=True)
    assert not (h + r - t).any()
    g_pos = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    g_negs = np.zeros((4, 3), np.float32)
    gh, gr, gt, gneg = tkge.kge_score_backward(
        *_t(h, r, t, neg, ch, g_pos, g_negs), "transe_l1")
    np.testing.assert_array_equal(gh.numpy(), np.broadcast_to(-g_pos[:, None], (4, 8)))
    np.testing.assert_array_equal(gr.numpy(), gh.numpy())
    np.testing.assert_array_equal(gt.numpy(), -gh.numpy())
    assert not gneg.numpy().any()
    # TransE-L2: x / sqrt(sum x^2 + 1e-12) is 0 at x = 0
    gh2, _, _, _ = tkge.kge_score_backward(
        *_t(h, r, t, neg, ch, g_pos, g_negs), "transe_l2")
    assert not gh2.numpy().any()


@pytest.mark.parametrize("model", MODELS)
def test_autograd_function_matches_torch_autograd_of_plain_forward(model):
    """Away from exact zeros the written-out backward is autograd's."""
    h, r, t, neg, ch = _inputs(12, 6, 40, seed=3)
    g_pos = torch.from_numpy(np.linspace(-1, 1, 12, dtype=np.float32))
    g_negs = torch.from_numpy(
        np.random.default_rng(1).standard_normal((12, 6)).astype(np.float32))

    def grads(fn):
        leaves = [x.requires_grad_(True) for x in _t(h, r, t, neg)]
        pos, negs = fn(*leaves, torch.from_numpy(ch), model)
        return torch.autograd.grad((pos, negs), leaves, (g_pos, g_negs))

    for g, w in zip(grads(tops.kge_score), grads(tref.kge_score_ref)):
        _close(g.numpy(), w.numpy(), 1e-5)


def test_autograd_function_with_one_output_unused():
    h, r, t, neg, ch = _t(*_inputs(5, 2, 6, seed=9))
    leaves = [x.requires_grad_(True) for x in (h, r, t, neg)]
    _, negs = tops.kge_score(*leaves, ch, "distmult")
    g = torch.autograd.grad(negs.sum(), leaves)
    want = tkge.kge_score_backward(*(x.detach() for x in leaves), ch,
                                   torch.zeros(5), torch.ones(5, 2),
                                   "distmult")
    for a, b in zip(g, want):
        _close(a.detach().numpy(), b.numpy(), 1e-6)


def test_cpu_tensors_take_the_plain_version():
    tkge.reset_launches()
    h, r, t, neg, ch = _t(*_inputs(3, 2, 4))
    tops.kge_score(h, r, t, neg, ch, "transe_l2")
    assert tkge.launches == {"kge_score_forward": 0, "kge_score_backward": 0}


@pytest.mark.parametrize("bad", ["model", "neg_shape", "dtype", "mask",
                                 "contiguous", "dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    h, r, t, neg, ch = _t(*_inputs(3, 2, 4))
    if bad == "model":
        with pytest.raises(ValueError, match="unknown kge_score model"):
            tkge.kge_score_forward(h, r, t, neg, ch, "transr")
        return
    if bad == "neg_shape":
        neg = neg[:, :, :3].contiguous()
    elif bad == "dtype":
        r = r.double()
    elif bad == "mask":
        ch = ch.int()
    elif bad == "contiguous":
        neg = neg.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "dim":
        h = torch.zeros(3, tkge.MAX_DIM + 1)
    with pytest.raises(ValueError):
        tkge._check(h, r, t, neg, ch)


def _bad(case):
    """Inputs of (3, 2, 4) with one fault; the message ``_check`` gives."""
    h, r, t, neg, ch = _t(*_inputs(3, 2, 4))
    if case == "h_3d":
        return (h[None], r, t, neg, ch), "h must be"
    if case == "empty_batch":
        return (h[:0], r[:0], t[:0], neg[:0], ch[:0]), "need B >= 1"
    if case == "no_negatives":
        return (h, r, t, neg[:, :0], ch[:, :0]), "need 1 <= K"
    if case == "too_many_negatives":
        big = torch.zeros(3, tkge.MAX_NEGS + 1, 4)
        return (h, r, t, big, torch.zeros(3, tkge.MAX_NEGS + 1,
                                          dtype=torch.bool)), "need 1 <= K"
    if case == "r_shape":
        return (h, r[:2], t, neg, ch), "r must be"
    if case == "t_on_other_device":
        return (h, r, t.to("meta"), neg, ch), "t must be"
    if case == "neg_float64":
        return (h, r, t, neg.double(), ch), "neg must be"
    if case == "h_not_contiguous":
        hh = torch.zeros(4, 3).T
        return (hh, r, t, neg, ch), "h must be"
    if case == "mask_shape":
        return (h, r, t, neg, ch[:, :1]), "corrupt_head must be"
    if case == "mask_not_contiguous":
        return (h, r, t, neg, ch.T.contiguous().T), "corrupt_head must be"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "h_3d", "empty_batch", "no_negatives", "too_many_negatives", "r_shape",
    "t_on_other_device", "neg_float64", "h_not_contiguous", "mask_shape",
    "mask_not_contiguous"])
def test_check_names_each_rejection(case):
    """The validation reads each tensor's metadata once and still raises
    ValueError, naming the operand, for everything the kernels refuse."""
    args, msg = _bad(case)
    with pytest.raises(ValueError, match=msg):
        tkge._check(*args)


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8])
def test_check_accepts_what_the_kernel_takes(mask_dtype):
    h, r, t, neg, ch = _t(*_inputs(3, 2, 4))
    assert tkge._check(h, r, t, neg, ch.to(mask_dtype)) == (3, 2, 4)


@pytest.mark.parametrize("B,K", [(1, 1), (3, 2), (1024, 32)])
def test_forward_outputs_are_contiguous_of_the_right_shapes(B, K):
    """pos (B,) and negs (B, K): float32, contiguous, not overlapping."""
    pos, negs = tkge.forward_outputs(B, K, torch.device("cpu"))
    assert pos.shape == (B,) and negs.shape == (B, K)
    assert pos.dtype == negs.dtype == torch.float32
    assert pos.is_contiguous() and negs.is_contiguous()
    a, b = pos.data_ptr(), negs.data_ptr()
    assert a + 4 * B <= b or b + 4 * B * K <= a


@pytest.mark.parametrize("B,K,d", [(1, 1, 1), (3, 7, 13), (1024, 32, 200)])
def test_backward_returns_separate_tensors_of_the_right_shapes(B, K, d):
    """grad h, r, t (B, d) and grad neg (B, K, d): float32, contiguous, not
    overlapping."""
    rng = np.random.default_rng(B + K + d)
    h, r, t = (torch.from_numpy(rng.standard_normal((B, d), np.float32))
               for _ in range(3))
    neg = torch.from_numpy(rng.standard_normal((B, K, d), np.float32))
    ch = torch.from_numpy(rng.random((B, K)) < 0.5)
    g_pos = torch.ones(B)
    g_negs = torch.ones(B, K)
    outs = tkge.kge_score_backward(h, r, t, neg, ch, g_pos, g_negs,
                                   "transe_l1")
    assert [o.shape for o in outs] == [(B, d)] * 3 + [(B, K, d)]
    assert all(o.dtype == torch.float32 and o.is_contiguous() for o in outs)
    spans = sorted((o.data_ptr(), o.data_ptr() + 4 * o.numel()) for o in outs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


#: the backward kernel's staging cases: the training shape (one bulk copy
#: a slab); K * d not a multiple of 4 (4-byte cp.async); one negative of
#: one coordinate; a slab larger than one stage (the two-stage ring of
#: bulk copies); d past 128 float4 columns (one group, column tiles)
CARD_GRID = [(1024, 32, 200), (3, 7, 13), (1, 1, 1), (4, 8192, 200),
             (2, 64, 4096)]


def _on_card(arrays, offset=0):
    """The arrays on the card; ``offset`` floats into a larger buffer, so
    that no row is 16-byte aligned."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if offset and t.dtype == torch.float32:
            buf = torch.empty(t.numel() + offset, device="cuda")
            view = buf[offset:].view(t.shape)
            view.copy_(t)
            out.append(view)
        else:
            out.append(t.to("cuda"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["random", "true", "false"])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("B,K,d", CARD_GRID)
def test_backward_kernel_matches_plain_on_card(B, K, d, model, mask):
    """The backward kernel against its plain version within 1e-4 (sums
    over K in another order), on every staging path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(B + K + d)
    arrays = (*_inputs(B, K, d, seed=B * K + d, mask=mask),
              rng.standard_normal(B).astype(np.float32),
              rng.standard_normal((B, K)).astype(np.float32))
    for offset in (0, 1):
        args = _on_card(arrays, offset)
        got = tkge.kge_score_backward(*args, model)
        want = tref.kge_score_backward_ref(*args, model)
        for g, w in zip(got, want):
            _close(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_backward_kernel_gives_the_same_bits_twice_on_card(model):
    """No atomics: the sums over K are combined in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    for B, K, d in ((1024, 32, 200), (4, 8192, 200), (3, 7, 13)):
        rng = np.random.default_rng(K)
        args = _on_card((*_inputs(B, K, d, seed=1),
                         rng.standard_normal(B).astype(np.float32),
                         rng.standard_normal((B, K)).astype(np.float32)))
        first = tkge.kge_score_backward(*args, model)
        second = tkge.kge_score_backward(*args, model)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_kernels_match_plain_on_card(model):
    """Forward and backward kernels against their plain versions on the
    card; skips on machines without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    arrays = _inputs(100, 5, 200, seed=2)
    h, r, t, neg, ch = (x.to(dev) for x in _t(*arrays))
    g_pos = torch.randn(100, device=dev)
    g_negs = torch.randn(100, 5, device=dev)
    tkge.reset_launches()
    got = tkge.kge_score_forward(h, r, t, neg, ch, model)
    got_b = tkge.kge_score_backward(h, r, t, neg, ch, g_pos, g_negs, model)
    assert tkge.launches == {"kge_score_forward": 1, "kge_score_backward": 1}
    want = tref.kge_score_ref(h, r, t, neg, ch, model)
    want_b = tref.kge_score_backward_ref(h, r, t, neg, ch, g_pos, g_negs,
                                         model)
    for g, w in zip(got + got_b, want + want_b):
        _close(g.cpu().numpy(), w.cpu().numpy())
