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
from hypothesis import given, settings, strategies as st

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


TIE_TOL = 1e-6      # on the card, runs of plain scores this close order freely


def _ids_agree(a, b, s_plain):
    """The card's contract (chip_smoke's rule, copied): ids equal position
    by position, except inside runs of plain scores closer than TIE_TOL,
    where only the sets must match; a run cut by the end of the row may
    hold different members.  Returns one (lo, hi, span) per run that
    needed the set rule, span being the run's plain-score spread."""
    if np.array_equal(a, b):
        return []
    n = len(a)
    brk = np.ones(n, bool)
    brk[1:] = (s_plain[:-1] - s_plain[1:]) >= TIE_TOL
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], n)
    run_of = np.cumsum(brk) - 1
    runs = []
    for rid in np.unique(run_of[a != b]):
        lo, hi = int(starts[rid]), int(ends[rid])
        if hi < n:
            assert np.array_equal(np.sort(a[lo:hi]), np.sort(b[lo:hi])), (
                f"ids differ outside a near-tie run at [{lo}, {hi}): "
                f"{a[lo:hi]} vs {b[lo:hi]}, plain scores {s_plain[lo:hi]}")
        runs.append((lo, hi, float(s_plain[lo] - s_plain[hi - 1])))
    assert len(np.unique(a)) == n, "duplicate ids in the kernel's result"
    return runs


def _assert_match_card(got, want, n, note=""):
    """_assert_match with ids under the near-tie rule; prints each run
    the rule relaxed (row, positions, ids both ways, plain-score span)."""
    s, i, v = (_np(x) for x in got)
    sr, ir, vr = (_np(x) for x in want)
    np.testing.assert_array_equal(v, vr, err_msg=note)
    assert s.shape == sr.shape, (note, s.shape, sr.shape)
    for r in range(s.shape[0]):
        for lo, hi, span in _ids_agree(i[r, :v[r]], ir[r, :v[r]],
                                       sr[r, :v[r]]):
            print(f"{note} row {r} near-tie run [{lo}, {hi}): kernel ids "
                  f"{i[r, lo:hi].tolist()} plain ids {ir[r, lo:hi].tolist()}"
                  f" plain scores {sr[r, lo:hi].tolist()} kernel scores "
                  f"{s[r, lo:hi].tolist()} span {span:.3e}")
        np.testing.assert_allclose(s[r, :v[r]], sr[r, :v[r]], rtol=TOL,
                                   atol=TOL, err_msg=note)
        assert (s[r, v[r]:] < -1e29).all(), note       # sentinel tail
        assert (i[r, :v[r]] < n).all(), note           # no pad row leaks


@pytest.mark.parametrize("swap,ok", [((3, 4), True), ((2, 3), False),
                                     ((5, 6), True), ((0, 6), False)])
def test_near_tie_rule(swap, ok):
    """The card's id rule: a swap inside a run of plain scores closer
    than TIE_TOL passes (a run cut by the row's end too), a swap across
    runs fails."""
    s = np.array([0.9, 0.8, 0.7, 0.6, 0.6 - 5e-7, 0.5, 0.5 - 2e-7],
                 np.float32)
    b = np.arange(7, dtype=np.int32)
    a = b.copy()
    a[list(swap)] = a[list(swap[::-1])]
    if ok:
        assert [lo for lo, _, _ in _ids_agree(a, b, s)] == [swap[0]]
    else:
        with pytest.raises(AssertionError, match="outside a near-tie"):
            _ids_agree(a, b, s)
    assert _ids_agree(b, b, s) == []


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


def _merge_replay(a, b, k):
    """The first ``k`` entries of the descending merge of ``a`` and ``b``
    as the merge-path kernel computes them: per tile of MERGE_TILE
    outputs, the two splits from ``merge_path_split``, then each entry
    placed by its rank in the other list's segment."""
    out = np.zeros(k, a.dtype)
    for o0 in range(0, k, tts.MERGE_TILE):
        o1 = min(o0 + tts.MERGE_TILE, k)
        a0, a1 = (tts.merge_path_split(a, b, o) for o in (o0, o1))
        ta, tb = a[a0:a1], b[o0 - a0:o1 - a1]
        assert len(ta) + len(tb) == o1 - o0
        # a entry: after the b entries strictly above it; b entry: after
        # the a entries at or above it (ta, tb descending)
        pos_a = np.arange(len(ta)) + np.searchsorted(-tb, -ta, side="left")
        pos_b = np.arange(len(tb)) + np.searchsorted(-ta, -tb, side="right")
        out[o0 + pos_a] = ta
        out[o0 + pos_b] = tb
    return out


MERGE_CASES = sorted({(k_run, m, k) for k_run in (0, 65, 2000)
                      for m in (1, 2000, 8192)
                      for k in (min(65, k_run + m), k_run + m)})


@pytest.mark.parametrize("k_run,m,k", MERGE_CASES)
def test_merge_path_split_on_every_diagonal(k_run, m, k):
    """The large-k merge on the host: for random unique keys, the split
    ``merge_path_split`` finds on every output diagonal is the number of
    running-list keys among the first ``diag`` of the union, and the
    kernel's tile-by-tile placement yields the union's top k in order."""
    rng = np.random.default_rng(1000 * k_run + m + k)
    keys = rng.choice(2 ** 62, size=k_run + m, replace=False).astype(np.int64)
    a = np.sort(keys[:k_run])[::-1]
    b = np.sort(keys[k_run:])[::-1]
    union = np.sort(keys)[::-1]
    from_a = np.concatenate([[0], np.cumsum(np.isin(union, a))])
    for diag in range(k + 1):
        assert tts.merge_path_split(a, b, diag) == from_a[diag], diag
    np.testing.assert_array_equal(_merge_replay(a, b, k), union[:k])


def test_merge_path_with_repeated_sentinels():
    """A first streamed step merges a running list of repeated sentinel
    keys; the replay still gives the union's top k, repeats included."""
    rng = np.random.default_rng(5)
    a = np.full(300, 7, np.int64)              # one key, 300 times
    b = np.sort(rng.choice(np.arange(1, 10 ** 6), 700, replace=False)
                )[::-1].astype(np.int64)
    b[400:450] = 7                             # slab entries equal to it
    b = np.sort(b)[::-1]
    union = np.sort(np.concatenate([a, b]))[::-1]
    for k in (65, 513, 1000):
        np.testing.assert_array_equal(_merge_replay(a, b, k), union[:k])


@pytest.mark.parametrize("rows,k,k_run", [
    (8192, 2000, 2000), (1024, 2000, 2000), (100_000, 300, 0),
    (100_000, 100_000, 0), (40_000, 65, 0)])
def test_large_k_merge_schedule(rows, k, k_run):
    """One merge launch per sub-slab of SORT_CAP rows, each output no
    longer than what it merges, the last one k long: a streamed slab
    is one merge (3 launches in all)."""
    merges = tts.large_k_merges(rows, k, k_run)
    assert len(merges) == -(-rows // tts.SORT_CAP)
    have = k_run
    for n_cand, k_out in merges:
        assert 1 <= n_cand <= min(k, tts.SORT_CAP)
        assert k_out == min(k, have + n_cand)
        have = k_out
    assert merges[-1][1] == k


@pytest.mark.parametrize("k", [65, 130, 257])
def test_large_k_step_ties_across_running_list_and_slab(k):
    """Exactly equal scores, half in the running list and half in the
    next slab: the stream step keeps the lower global index first across
    the merge, as the reference's one-shot top-k does."""
    rng = np.random.default_rng(k)
    base = rng.integers(-2, 3, size=(150, 16)).astype(np.float32)
    e = np.concatenate([base, base])            # row j == row j + 150
    q = rng.integers(-2, 3, size=(3, 16)).astype(np.float32)
    ones = np.ones(300, np.float32)
    qt, et, nt = (torch.from_numpy(x) for x in (q, e, ones))
    excl = torch.full((3,), -1, dtype=torch.int32)
    run_s, run_i = tts.topk_cosine_step(qt, et[:150], nt[:150], excl, 0, 300,
                                        min(k, 150))
    s, i = tts.topk_cosine_step(qt, et[150:], nt[150:], excl, 150, 300, k,
                                run_s, run_i)
    want = jref.topk_cosine_ref(jnp.asarray(q), jnp.asarray(e), k)
    _assert_match((s, i, torch.full((3,), k)), want, 300, f"ties k={k}")
    s, i = s.numpy(), i.numpy()
    tied = 0
    for r in range(3):
        for j in range(k - 1):
            if s[r, j] == s[r, j + 1]:
                assert i[r, j] < i[r, j + 1]
                tied += i[r, j] < 150 <= i[r, j + 1]
    assert tied > 0             # some ties ran across the merge


def _masked_scores(q, blk, offset, limit, excl):
    """The slab's masked scores as ``stream_step_ref`` forms them."""
    s = (torch.from_numpy(q) @ torch.from_numpy(blk).T).numpy()
    col = offset + np.arange(blk.shape[0])
    s = np.where(col[None, :] < limit, s, np.float32(tref.NEG_INF))
    return np.where(col[None, :] == excl[:, None], np.float32(tref.NEG_INF),
                    s).astype(np.float32)


@settings(max_examples=60, deadline=None)
@given(qn=st.integers(1, 3), rows=st.integers(1, 300),
       prev=st.integers(0, 150), k=st.integers(1, 64),
       k_run=st.integers(1, 70), limit_cut=st.integers(0, 40),
       dup=st.booleans(), excl_mode=st.sampled_from(["none", "slab", "prev"]),
       seed=st.integers(0, 10 ** 6))
def test_small_k_block_select_and_merge_match_the_plain_step(
        qn, rows, prev, k, k_run, limit_cut, dup, excl_mode, seed):
    """The k <= 64 step's index logic, replayed on the host
    (``small_k_merge_model``: each 64-row block's best min(k, 64), then
    the warps' pruned merges of those runs and the running list), equals
    ``stream_step_ref`` exactly: integer data makes ties everywhere,
    duplicate rows must resolve to the lower index, ``limit`` may cut
    the slab, the running list repeats its sentinel when the rows before
    the slab were fewer than it holds, the last block is ragged, and k
    may exceed the slab's rows."""
    rng = np.random.default_rng(seed)
    d = 8
    k = min(k, k_run + rows)
    table = rng.integers(-2, 3, size=(prev + rows, d)).astype(np.float32)
    if dup and prev + rows > 1:        # copies of earlier rows, some across
        src = rng.integers(0, prev + rows - 1, size=(prev + rows) // 3)
        dst = rng.integers(src + 1, prev + rows)
        table[dst] = table[src]
    q = rng.integers(-2, 3, size=(qn, d)).astype(np.float32)
    limit = prev + rows - min(limit_cut, rows - 1)
    excl = {"none": np.full(qn, -1),
            "slab": rng.integers(prev, prev + rows, qn),
            "prev": rng.integers(0, max(prev, 1), qn)}[excl_mode]
    excl = excl.astype(np.int32)
    qt, xt = torch.from_numpy(q), torch.from_numpy(excl)
    # the running list as the streaming driver builds it: sentinels, then
    # the step over the rows before the slab
    run_s = torch.full((qn, k_run), tref.NEG_INF, dtype=torch.float32)
    run_i = torch.zeros((qn, k_run), dtype=torch.int32)
    if prev:
        run_s, run_i = tref.stream_step_ref(
            qt, torch.from_numpy(table[:prev]), None, 0, limit, xt, run_s,
            run_i, k_run)
    want_s, want_i = tref.stream_step_ref(
        qt, torch.from_numpy(table[prev:]), None, prev, limit, xt, run_s,
        run_i, k)
    keys = tts.score_keys(_masked_scores(q, table[prev:], prev, limit, excl),
                          prev + np.arange(rows))
    run_keys = tts.score_keys(run_s.numpy(), run_i.numpy())
    assert (run_keys[:, :-1] >= run_keys[:, 1:]).all()      # sorted
    got_s, got_i = tts.decode_keys(tts.small_k_merge_model(keys, run_keys, k))
    np.testing.assert_array_equal(got_s, want_s.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())


@pytest.mark.parametrize("rows,k", [(1, 1), (5, 10), (63, 64), (64, 64),
                                    (65, 10), (8192, 10), (100_000, 10)])
def test_small_k_first_step_without_running_list(rows, k):
    """With no running list (a device-resident call steps once over the
    whole table) the replay is the table's top k; rows < k pads with
    the sentinel.  Large row counts only exercise the warp schedule, so
    their scores are cheap random integers."""
    rng = np.random.default_rng(rows + k)
    scores = rng.integers(-50, 50, size=(2, rows)).astype(np.float32)
    keys = tts.score_keys(scores, np.arange(rows))
    got_s, got_i = tts.decode_keys(tts.small_k_merge_model(keys, None, k))
    order = np.lexsort((np.arange(rows)[None, :].repeat(2, 0), -scores))
    for r in range(2):
        n = min(k, rows)
        np.testing.assert_array_equal(got_i[r, :n], order[r, :n])
        np.testing.assert_array_equal(got_s[r, :n], scores[r, order[r, :n]])
        assert (got_s[r, n:] == tref.NEG_INF).all() and (got_i[r, n:] == 0).all()


def test_score_keys_order_and_round_trip():
    """Keys sort as (score descending, index ascending), -0 equals +0,
    and decode back exactly; key 0 decodes to the sentinel."""
    s = np.array([1.5, -0.0, 0.0, -1e30, 1.5, -2.25, 3e-8], np.float32)
    i = np.array([7, 3, 2, 0, 4, 1, 9], np.int32)
    keys = tts.score_keys(s, i)
    want = sorted(range(len(s)), key=lambda j: (-float(s[j]), int(i[j])))
    assert [int(x) for x in np.argsort(keys)[::-1]] == want
    ds, di = tts.decode_keys(keys)
    np.testing.assert_array_equal(ds, np.where(s == 0, 0, s))
    np.testing.assert_array_equal(di, i)
    zs, zi = tts.decode_keys(np.zeros(2, np.uint64))
    assert (zs == tref.NEG_INF).all() and (zi == 0).all()


@pytest.mark.parametrize("n_lists,warps", [(1, 1), (8, 1), (9, 2), (128, 16),
                                          (129, 32), (1563, 32)])
def test_merge_lists_warps(n_lists, warps):
    """About 8 runs a warp, a power of two, at most 32 warps: a streamed
    8192-row slab (128 runs) gets 16 warps, a 100k-row table 32."""
    assert tts.merge_lists_warps(n_lists) == warps


def _step_args(**bad):
    """Arguments of one valid slab step (Q 3, rows 10, d 4, k 5 with a
    running list of 5), with the named ones replaced."""
    args = dict(q=torch.zeros(3, 4), blk=torch.zeros(10, 4),
                norms=torch.ones(10),
                excl=torch.full((3,), -1, dtype=torch.int32),
                offset=0, limit=10, k=5, run_s=torch.zeros(3, 5),
                run_i=torch.zeros(3, 5, dtype=torch.int32))
    args.update(bad)
    return args


@pytest.mark.parametrize("bad,msg", [
    (dict(blk=torch.zeros(10, 4, dtype=torch.float64)), "table slab"),
    (dict(blk=torch.zeros(4, 10).T), "table slab"),
    (dict(blk=torch.zeros(0, 4)), "empty table slab"),
    (dict(q=torch.zeros(3, 5)), "queries"),
    (dict(q=torch.zeros(5, 3).T), "queries"),
    (dict(norms=torch.ones(9)), "norms"),
    (dict(excl=torch.full((3,), -1, dtype=torch.int64)), "exclude_rows"),
    (dict(run_i=None), "go together"),
    (dict(run_i=torch.zeros(3, 4, dtype=torch.int32)), "running list"),
    (dict(run_s=torch.zeros(3, 5).to("meta")), "running list"),
    (dict(k=16), "outside"),
    (dict(offset=2 ** 31 - 5), "int32 range"),
])
def test_step_check_rejects_what_the_kernels_do_not_take(bad, msg):
    """The CUDA path's validation (it reads each tensor's metadata once)
    raises ValueError for every fault; a valid step passes."""
    tts._check(**_step_args())
    with pytest.raises(ValueError, match=msg):
        tts._check(**_step_args(**bad))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 65, 2000, "N"])
def test_kernel_matches_plain_on_card(k):
    """The CUDA kernel against its plain version on the card (both k
    paths, k up to N), ids under the near-tie rule (the two sum in another
    order); skips on machines without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    k = 3000 if k == "N" else k
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
    _assert_match_card(tuple(t.cpu() for t in got),
                       tuple(t.cpu() for t in want), 3000, f"card k={k}")


@pytest.mark.parametrize("qn,want", [
    (1, [(0, 1)]), (65_535, [(0, 65_535)]),
    (65_536, [(0, 65_535), (65_535, 1)]),
    (140_000, [(0, 65_535), (65_535, 65_535), (131_070, 8_930)])])
def test_large_k_query_chunks_cover_every_query_once(qn, want):
    """Select/sort and merge path put the query on the grid's y axis:
    one launch each up to 65,535 queries, one more per 65,535 past it."""
    chunks = tts.query_chunks(qn)
    assert chunks == want
    assert all(0 < n <= tts.MAX_GRID_Y for _, n in chunks)
    assert sum(n for _, n in chunks) == qn


@pytest.mark.cuda
def test_large_k_step_past_the_grid_y_limit_on_card():
    """A k > 64 slab step over 65,536 queries (one past the grid's y
    limit) against the plain step on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    qn, rows, d, k = 65_536, 512, 64, 100
    rng = np.random.default_rng(11)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.standard_normal((rows, d)).astype(np.float32)
    q_d, e_d = torch.from_numpy(q).to(dev), torch.from_numpy(e).to(dev)
    excl = torch.from_numpy((np.arange(qn) % rows).astype(np.int32)).to(dev)
    tts.reset_launches()
    got = tts.topk_cosine_step(q_d, e_d, None, excl, 0, rows, k)
    assert tts.launches["topk_select_sort"] == 2
    assert tts.launches["topk_merge_path"] == 2
    want = tref.stream_step_ref(q_d, e_d, None, 0, rows, excl, None, None, k)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=TOL, atol=TOL)
