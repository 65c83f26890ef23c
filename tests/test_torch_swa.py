"""The port's sliding-window attention against the JAX package's.

The same inputs, made by numpy from a seed, go through the JAX package
(``repro.kernels.ref.swa_attention_ref``, ``swa_attention_pallas`` in
interpret mode, and the zoo's attention functions in
``repro.models.attention``) and through the port (its plain
``swa_attention_ref``, the kernel's wrapper, which runs the plain version
on a CPU tensor, ``ops.swa_attention`` and ``models/attention.py``).
Tolerances: 1e-5 between the two packages' plain fp32 functions (sums
taken in another order), 2e-4 against the Pallas kernel (the reference's
own, ``tests/test_kernels.py``).  The CUDA kernel runs only on a card (the
``cuda`` test at the end, and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.swa_attention import swa_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_attention as tswa
from repro_torch.models import attention as tattn

TOL = 1e-5
PALLAS_TOL = 2e-4

#: (B, Hq, Hkv, Sq, Skv, d, window, q_offset)
REF_CASES = [
    (1, 2, 1, 128, 128, 32, 32, 0),
    (2, 4, 2, 80, 80, 64, 64, 0),          # reduced h2o: S wraps W
    (2, 4, 4, 80, 80, 64, 64, 0),          # kv repeated to 4 groups
    (1, 6, 2, 37, 300, 80, 128, 263),      # q_offset, Sq < Skv
    (2, 2, 1, 1, 50, 16, 8, 49),           # one decode query
    (1, 4, 2, 33, 33, 16, 1, 0),           # W = 1: each query sees itself
    (1, 2, 2, 45, 45, 32, 1000, 0),        # W >= S: full causal
    (2, 8, 2, 131, 131, 128, 50, 0),       # ragged S
]
#: test_kernels.py's three shapes, then the edges of the contract
PALLAS_CASES = [
    (1, 2, 1, 128, 128, 32, 32, 0),
    (2, 4, 2, 256, 256, 64, 64, 0),
    (1, 1, 1, 64, 64, 16, 128, 0),
    (1, 4, 2, 40, 200, 32, 64, 160),       # q_offset > 0, Sq < Skv
    (1, 2, 1, 70, 70, 16, 1, 0),           # W = 1
    (1, 2, 2, 90, 90, 64, 500, 0),         # W >= S, ragged
    (1, 4, 1, 150, 150, 80, 40, 0),        # ragged S, h2o's d
]


def _qkv(B, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((B, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((B, hkv, skv, d), dtype=np.float32)
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _fold(x):
    return x.reshape((-1,) + x.shape[2:])


@pytest.mark.parametrize("case", REF_CASES, ids=str)
def test_plain_matches_jax_ref(case):
    B, hq, hkv, sq, skv, d, W, off = case
    q, k, v = _qkv(B, hq, hkv, sq, skv, d, seed=sq + d)
    want = jref.swa_attention_ref(*map(jnp.asarray, (q, k, v)), window=W,
                                  q_offset=off)
    got = tref.swa_attention_ref(*_t(q, k, v), W, off)
    assert got.shape == (B, hq, sq, d) and got.dtype == torch.float32
    _close(got, want, TOL)


@pytest.mark.parametrize("case", PALLAS_CASES, ids=str)
def test_wrapper_matches_pallas_interpret(case):
    """The wrapper in the folded layout (plain version on the CPU) against
    the TPU kernel run in interpret mode on the same folded tensors."""
    B, hq, hkv, sq, skv, d, W, off = case
    q, k, v = (_fold(x) for x in _qkv(B, hq, hkv, sq, skv, d, seed=W + sq))
    want = swa_attention_pallas(*map(jnp.asarray, (q, k, v)), window=W,
                                q_offset=off, interpret=True)
    got = tswa.swa_attention_forward(*_t(q, k, v), W, off)
    assert got.shape == (B * hq, sq, d)
    _close(got, want, PALLAS_TOL)


@pytest.mark.parametrize("case", REF_CASES[:4], ids=str)
def test_ops_folds_heads_as_the_reference(case):
    """``ops.swa_attention`` on (B, H, S, d) equals the reference layout's
    plain version: kv row = q row // (Hq / Hkv) after folding."""
    B, hq, hkv, sq, skv, d, W, off = case
    q, k, v = _qkv(B, hq, hkv, sq, skv, d, seed=5)
    want = jref.swa_attention_ref(*map(jnp.asarray, (q, k, v)), window=W,
                                  q_offset=off)
    _close(tops.swa_attention(*_t(q, k, v), W, off), want, TOL)


def test_bf16_inputs_give_bf16_output_near_fp32():
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=9)
    got = tswa.swa_attention_forward(*(x.to(torch.bfloat16) for x in
                                       _t(_fold(q), _fold(k), _fold(v))), 16)
    assert got.dtype == torch.bfloat16
    want = tswa.swa_attention_forward(*_t(_fold(q), _fold(k), _fold(v)), 16)
    _close(got.float(), want, 3e-2)


def test_plain_path_launches_nothing():
    tswa.reset_launches()
    q, k, v = _qkv(1, 2, 1, 16, 16, 16)
    tswa.swa_attention_forward(*_t(_fold(q), _fold(k), _fold(v)), 4)
    assert tswa.launches == {"swa_attention_forward": 0}


@pytest.mark.parametrize("bad", ["dtype", "mixed", "hd", "groups", "shape",
                                 "contiguous", "window", "q_offset", "dims"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(4, 16, 32), torch.zeros(2, 16, 32),
               torch.zeros(2, 16, 32))
    W, off = 8, 0
    if bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "mixed":
        k = k.double()
    elif bad == "hd":
        q, k, v = (torch.zeros(x.shape[:2] + (48,)) for x in (q, k, v))
    elif bad == "groups":
        k, v = torch.zeros(3, 16, 32), torch.zeros(3, 16, 32)
    elif bad == "shape":
        v = torch.zeros(2, 15, 32)
    elif bad == "contiguous":
        q = torch.zeros(16, 4, 32).transpose(0, 1)
    elif bad == "window":
        W = 0
    elif bad == "q_offset":
        off = -1
    elif bad == "dims":
        q = q[None]
    with pytest.raises(ValueError):
        tswa.swa_attention_forward(q, k, v, W, off)


# ----------------- models/attention.py against JAX's ------------------ #
def _grouped(B, sq, sk, G, H, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, G, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, sk, G, hd), dtype=np.float32)
    v = rng.standard_normal((B, sk, G, hd), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,G,H,hd,W", [
    (2, 80, 2, 2, 64, 64),         # reduced h2o's layout: the window wraps
    (1, 100, 4, 1, 32, 16),        # one q head per kv group
    (2, 40, 2, 3, 16, 40),         # W = S
])
def test_model_swa_attention_matches_jax(B, S, G, H, hd, W):
    q, k, v = _grouped(B, S, S, G, H, hd, seed=S)
    want = jattn.swa_attention(*map(jnp.asarray, (q, k, v)), window=W,
                               chunk_q=32)
    got = tattn.swa_attention(*_t(q, k, v), window=W)
    assert got.shape == (B, S, G, H, hd)
    _close(got, want, TOL)


def test_model_swa_attention_q_offset_is_the_kernels():
    """With Sq < Sk, q[:, i] sits at key position q_offset + i: the grouped
    layout folds to the reference's (B, H, S, d) contract."""
    B, G, H, hd, W, sq, sk = 2, 2, 3, 16, 8, 10, 34
    q, k, v = _grouped(B, sq, sk, G, H, hd, seed=11)
    want = jref.swa_attention_ref(
        jnp.asarray(q.transpose(0, 2, 3, 1, 4).reshape(B, G * H, sq, hd)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), window=W, q_offset=sk - sq)
    got = tattn.swa_attention(*_t(q, k, v), window=W, q_offset=sk - sq)
    _close(got.permute(0, 2, 3, 1, 4).reshape(B, G * H, sq, hd), want, TOL)


@pytest.mark.parametrize("causal,off,chunk", [(True, 0, 16), (False, 0, 16),
                                              (True, 7, 512), (True, 0, 24)])
def test_chunked_attention_matches_jax(causal, off, chunk):
    q, k, v = _grouped(2, 45, 45, 2, 2, 32, seed=chunk + off)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, q_offset=off,
                                   chunk_q=chunk, chunk_kv=chunk)
    got = tattn.chunked_attention(*_t(q, k, v), causal=causal, q_offset=off,
                                  chunk_q=chunk, chunk_kv=chunk)
    _close(got, want, TOL)


@pytest.mark.parametrize("causal,off", [(False, 0), (True, 0), (True, 5)])
def test_plain_attention_matches_jax(causal, off):
    q, k, v = _grouped(2, 12, 17, 2, 2, 16, seed=3)
    want = jattn.plain_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 q_offset=off)
    got = tattn.plain_attention(*_t(q, k, v), causal=causal, q_offset=off)
    _close(got, want, TOL)


@pytest.mark.parametrize("n_valid", [1, 30, 64])
def test_decode_attention_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    q = rng.standard_normal((2, 1, 2, 3, 32), dtype=np.float32)
    kc = rng.standard_normal((2, 2, 64, 32), dtype=np.float32)
    vc = rng.standard_normal((2, 2, 64, 32), dtype=np.float32)
    want = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                  jnp.asarray(n_valid))
    got = tattn.decode_attention(*_t(q, kc, vc), n_valid)
    _close(got, want, TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version on the card; skips on
    machines without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    tswa.reset_launches()
    for B, hq, hkv, sq, skv, d, W, off in REF_CASES:
        q, k, v = (torch.from_numpy(_fold(x)).cuda().to(dt)
                   for x in _qkv(B, hq, hkv, sq, skv, d))
        got = tswa.swa_attention_forward(q, k, v, W, off).float()
        want = tref.swa_attention_ref(q[None], k[None], v[None], W,
                                      off)[0].float()
        tol = PALLAS_TOL if dt == torch.float32 else 1e-2 * (1 + want.abs())
        assert bool(((got - want).abs() <= tol).all())
    assert tswa.launches["swa_attention_forward"] == len(REF_CASES)
