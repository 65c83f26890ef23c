"""The port's top-k against the JAX package, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the one-shot
oracle, the jnp streaming step, and the Pallas kernel in interpret mode)
and through ``repro_torch.kernels`` (plain PyTorch versions and the
streaming driver with ``device="cpu"``).  Indices and ``valid`` must match
exactly; scores within 1e-5 (fp32 sums in another order); entries past
``valid`` are sentinel padding and are not compared beyond their score.

Grid (from tests/test_blocked_topk.py and tests/test_kernels.py): k >
block, a partial final block, an exclusion in the last block, k == N,
k > N, ragged N, the paper's d = 200, norm folding, duplicate rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_similarity as tts

TOL = 1e-5

# (Q, N, d, k, block)
GRID = [
    (2, 21, 16, 12, 8),      # k > block AND partial final block
    (3, 21, 16, 5, 8),       # partial final block, small k
    (2, 16, 8, 16, 8),       # k == N, block-multiple N
    (1, 7, 8, 10, 8),        # k > N (clamped), single partial block
    (2, 64, 32, 64, 16),     # k == N across many blocks
    (4, 257, 32, 5, 64),     # ragged N
    (8, 64, 200, 10, 32),    # the paper's dim and k
]


def _data(case, seed=0):
    Q, N, d, k, block = case
    rng = np.random.default_rng(seed + 1000 * N + k)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = (rng.standard_normal((N, d)) * rng.uniform(0.5, 3.0, (N, 1))
         ).astype(np.float32)                      # raw rows, varied norms
    nrm = np.linalg.norm(e, axis=1).astype(np.float32)
    # exclusion in the FINAL block on even queries, none on odd ones
    excl = np.array([N - 1 if i % 2 == 0 else -1 for i in range(Q)],
                    np.int32)
    return q, e, nrm, excl


def _unit(e, nrm):
    return e / np.maximum(nrm[:, None], 1e-12)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_match(got, want, n, note=""):
    s, i, v = (_np(x) for x in got)
    sr, ir, vr = (_np(x) for x in want)
    np.testing.assert_array_equal(v, vr, err_msg=note)
    assert s.shape == sr.shape, (note, s.shape, sr.shape)
    for r in range(s.shape[0]):
        np.testing.assert_array_equal(i[r, :v[r]], ir[r, :v[r]], err_msg=note)
        np.testing.assert_allclose(s[r, :v[r]], sr[r, :v[r]], rtol=TOL,
                                   atol=TOL, err_msg=note)
        assert (s[r, v[r]:] < -1e29).all(), note       # sentinel tail
        assert (i[r, :v[r]] < n).all(), note           # no pad row leaks


def _jax_oracle(q, e, nrm, k, excl):
    return jref.topk_cosine_ref(jnp.asarray(q), jnp.asarray(_unit(e, nrm)), k,
                                exclude_rows=jnp.asarray(excl))


@pytest.mark.parametrize("case", GRID)
@pytest.mark.parametrize("oracle", ["one_shot", "blocked"])
def test_plain_versions_match_jax(case, oracle):
    """repro_torch.kernels.ref vs repro.kernels.ref on the same inputs."""
    q, e, nrm, excl = _data(case)
    Q, N, d, k, block = case
    want = _jax_oracle(q, e, nrm, k, excl)
    if oracle == "one_shot":
        got = tref.topk_cosine_ref(torch.from_numpy(q),
                                   torch.from_numpy(_unit(e, nrm)), k,
                                   exclude_rows=torch.from_numpy(excl))
    else:
        got = tref.topk_cosine_blocked_ref(
            torch.from_numpy(q), torch.from_numpy(e), k,
            exclude_rows=torch.from_numpy(excl),
            norms=torch.from_numpy(nrm), block_n=block)
        _assert_match(got, jref.topk_cosine_blocked_ref(
            jnp.asarray(q), jnp.asarray(e), k,
            exclude_rows=jnp.asarray(excl), norms=jnp.asarray(nrm),
            block_n=block), N, f"blocked vs jax blocked {case}")
    _assert_match(got, want, N, f"{oracle} {case}")


@pytest.mark.parametrize("case", GRID)
@pytest.mark.parametrize("with_norms", [False, True])
def test_streaming_matches_jax(case, with_norms):
    """Host-table streaming driver (block_rows forced tiny) vs the JAX
    one-shot oracle and the JAX jnp streaming path."""
    q, e, nrm, excl = _data(case)
    Q, N, d, k, block = case
    table = e if with_norms else _unit(e, nrm)
    norms = nrm if with_norms else None
    got = tops.topk_cosine(q, table, k, exclude_rows=excl, norms=norms,
                           block_rows=block, device="cpu")
    assert all(t.device.type == "cpu" for t in got)
    _assert_match(got, _jax_oracle(q, e, nrm, k, excl), N, f"oracle {case}")
    _assert_match(got, jops.topk_cosine(
        q, table, k, exclude_rows=excl, norms=norms, use_pallas=False,
        block_rows=block), N, f"jax stream {case}")
    i, v = got[1].numpy(), got[2].numpy()
    for r in range(0, Q, 2):
        assert N - 1 not in i[r, :v[r]]                # exclusion held


@pytest.mark.parametrize("case", GRID)
def test_device_tensor_path_matches_jax(case):
    """A torch.Tensor table takes the single-call path on its device."""
    q, e, nrm, excl = _data(case)
    Q, N, d, k, block = case
    got = tops.topk_cosine(q, torch.from_numpy(e), k, exclude_rows=excl,
                           norms=torch.from_numpy(nrm))
    _assert_match(got, _jax_oracle(q, e, nrm, k, excl), N, f"device {case}")


@pytest.mark.parametrize("case", [GRID[0], GRID[4], GRID[5]])
def test_streaming_matches_pallas_interpret(case):
    """Against ``topk_cosine(..., use_pallas=True)`` (the Pallas kernel in
    interpret mode, as the JAX package's tests run it on the CPU), with
    equal ``stream_stats``: calls, slabs, and the peak slab transfer of
    rows*d*4 + rows*4 bytes."""
    q, e, nrm, excl = _data(case, seed=5)
    Q, N, d, k, block = case
    jops.reset_stream_stats()
    want = jops.topk_cosine(q, e, k, exclude_rows=excl, norms=nrm,
                            use_pallas=True, block_rows=block)
    tops.reset_stream_stats()
    got = tops.topk_cosine(q, e, k, exclude_rows=excl, norms=nrm,
                           block_rows=block, device="cpu")
    _assert_match(got, want, N, f"pallas {case}")
    assert tops.stream_stats == jops.stream_stats
    assert tops.stream_stats["peak_block_bytes"] == \
        min(block, N) * d * 4 + min(block, N) * 4


def test_join_matches_jax():
    """Slab-iterated kNN join: same slabs, same ids; scores within 1e-6
    (the JAX package's own join is 1 ulp off its per-query path)."""
    q, e, nrm, excl = _data((37, 90, 24, 7, 16), seed=3)
    excl = np.arange(37, dtype=np.int32) * 2
    got = list(tops.topk_cosine_join(q, e, 7, exclude_rows=excl, norms=nrm,
                                     query_block_rows=16, block_rows=32,
                                     device="cpu"))
    want = list(jops.topk_cosine_join(q, e, 7, exclude_rows=excl, norms=nrm,
                                      use_pallas=False, query_block_rows=16,
                                      block_rows=32))
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 16, 32]
    for (_, s, i, v), (_, sr, ir, vr) in zip(got, want):
        np.testing.assert_array_equal(v, vr)
        np.testing.assert_array_equal(i, ir)
        np.testing.assert_allclose(s, sr, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [3, 10, 70])
def test_duplicate_rows_lower_index_wins(k):
    """Integer-valued rows and queries make every score exact in any
    summation order, so duplicated rows tie exactly: the lower global
    index must come first, in both packages."""
    rng = np.random.default_rng(11)
    base = rng.integers(-2, 3, size=(45, 16)).astype(np.float32)
    e = np.concatenate([base, base])                 # row j == row j + 45
    q = rng.integers(-2, 3, size=(3, 16)).astype(np.float32)
    ones = np.ones(90, np.float32)
    got = tops.topk_cosine(q, e, k, norms=ones, block_rows=32, device="cpu")
    want = jref.topk_cosine_ref(jnp.asarray(q), jnp.asarray(e), k)
    _assert_match(got, want, 90, f"duplicates k={k}")
    s, i = got[0].numpy(), got[1].numpy()
    for r in range(3):
        for j in range(k - 1):
            if s[r, j] == s[r, j + 1]:
                assert i[r, j] < i[r, j + 1]


def test_k_exceeds_table_and_exclusion_regression():
    """k > N clamps to N and ``valid`` counts the real entries (the
    reference's k > N regression, tests/test_kernels.py)."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    e = rng.standard_normal((3, 8)).astype(np.float32)
    nrm = np.linalg.norm(e, axis=1).astype(np.float32)
    excl = np.array([1, -1], np.int32)
    s, i, v = tops.topk_cosine(q, e, 10, exclude_rows=excl, norms=nrm,
                               device="cpu")
    assert tuple(s.shape) == (2, 3)
    assert v.tolist() == [2, 3]
    assert 1 not in i[0, :2].tolist()
    _assert_match((s, i, v), _jax_oracle(q, e, nrm, 10, excl), 3)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the result is the plain step's, bit for bit."""
    q, e, nrm, excl = (torch.from_numpy(x) for x in _data(GRID[1]))
    tts.reset_launches()
    got = tts.topk_cosine_step(q, e, nrm, excl, 0, 21, 5)
    want = tref.stream_step_ref(q, e, nrm, 0, 21, excl, None, None, 5)
    assert all(n == 0 for n in tts.launches.values())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("P", [2, 4, 64, 2048, 4096, 32768])
def test_bitonic_schedule_sorts_descending(P):
    """The launch schedule of the k > 64 path, replayed on the host with
    the kernels' compare-exchange rule, sorts unique keys descending."""
    keys = np.random.default_rng(P).permutation(P).astype(np.int64)
    tile = min(tts.SORT_TILE, P)

    def passes(size, strides):
        for stride in strides:
            idx = np.arange(P)
            i = idx[(idx & stride) == 0]
            l = i + stride
            desc = (i & size) == 0
            a, b = keys[i], keys[l]
            swap = np.where(desc, a < b, a > b)
            keys[i[swap]], keys[l[swap]] = b[swap], a[swap]

    for kind, x, y in tts.bitonic_schedule(P):
        if kind == "global":
            passes(x, [y])
        else:
            size = x
            while size <= y:
                stride = min(size, tile) // 2
                passes(size, [stride >> j for j in range(stride.bit_length())
                              if stride >> j])
                size *= 2
    np.testing.assert_array_equal(keys, np.arange(P)[::-1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 65])
def test_kernel_matches_plain_on_card(k):
    """The CUDA kernel against its plain version on the card (both k
    paths); skips on machines without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, e, nrm, excl = _data((8, 3000, 200, k, 512))
    dev = torch.device("cuda")
    tts.reset_launches()
    got = tops.topk_cosine(q, e, k, exclude_rows=excl, norms=nrm,
                           block_rows=512, device=dev)
    assert sum(tts.launches.values()) > 0
    want = tref.topk_cosine_blocked_ref(
        torch.from_numpy(q).to(dev), torch.from_numpy(e).to(dev), k,
        exclude_rows=torch.from_numpy(excl).to(dev),
        norms=torch.from_numpy(nrm).to(dev), block_n=512)
    _assert_match(tuple(t.cpu() for t in got), tuple(t.cpu() for t in want),
                  3000, f"card k={k}")
