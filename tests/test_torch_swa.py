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

The backward: the port's plain backward (``ref.swa_attention_backward_ref``
with ``ref.swa_attention_lse_ref``), folded through the wrapper and
unfolded, and ``SWAAttentionFn`` on CPU tensors, against ``jax.vjp`` of the
reference's plain function and of the zoo's jnp scan (what the reference
trains through), within 2e-4; on the card the three backward kernels and
the forward's log-sum-exp against the plain versions (fp32 2e-4, bf16 the
forward's 1e-2 * (1 + |plain|)), and two runs bit for bit.  The tile
plans the kernels walk (the forward's and dQ's, and the dK/dV kernels'
transpose of it) are replayed on the host: they cover the band exactly,
mask only edge tiles, and the replay of the dK/dV arithmetic over the
transposed plan equals the plain backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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
    q, k, v = _t(*(_fold(x) for x in _qkv(1, 2, 1, 16, 16, 16)))
    tswa.swa_attention_forward(q, k, v, 4)
    o, lse = tswa.swa_attention_forward(q, k, v, 4, return_lse=True)
    tswa.swa_attention_backward(q, k, v, o, lse, torch.ones_like(o), 4)
    assert tswa.launches == {"swa_attention_forward": 0,
                             "swa_attention_bwd_dot": 0,
                             "swa_attention_backward_dkdv": 0,
                             "swa_attention_backward_dq": 0}


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
    if bad in ("hd", "contiguous"):
        # the kernel's own limits: the plain version on these CPU tensors
        # answers, and only the card path refuses them
        assert tswa.swa_attention_forward(q, k, v, W, off).shape == q.shape
        with pytest.raises(ValueError):
            tswa._check_kernel(q, k, v)
        return
    with pytest.raises(ValueError):
        tswa.swa_attention_forward(q, k, v, W, off)


@pytest.mark.parametrize("d", [96, 192])
def test_plain_path_takes_head_dims_the_kernel_does_not(d):
    """Head dims outside the kernel's build (96, 192) go through the plain
    version on CPU tensors, as the reference computes them."""
    assert d not in tswa.HEAD_DIMS
    B, hq, hkv, S, W = 1, 2, 1, 40, 8
    q, k, v = _qkv(B, hq, hkv, S, S, d, seed=d)
    want = jref.swa_attention_ref(*map(jnp.asarray, (q, k, v)), window=W)
    got = tswa.swa_attention_forward(*_t(_fold(q), _fold(k), _fold(v)), W)
    assert got.shape == (B * hq, S, d)
    _close(got.reshape(B, hq, S, d), want, PALLAS_TOL)
    _close(tops.swa_attention(*_t(q, k, v), W), want, PALLAS_TOL)


# --------------------------- the tile plan ----------------------------- #
def _visible(sq, skv, window, q_offset):
    """visible[i, j]: query i sees key j (the kernel's contract)."""
    i = q_offset + np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    return (j <= i) & (i - j < window)


def _assert_plan_holds(sq, skv, window, q_offset, bq, bk):
    """Every visible pair lies in a visited tile; every visited tile holds
    a visible pair; an interior tile is wholly visible and ends inside
    Skv; a masked tile holds at least one invisible pair (keys past Skv
    count as invisible)."""
    vis = _visible(sq, skv, window, q_offset)
    plan = tswa.swa_tile_plan(sq, skv, window, q_offset, bq, bk)
    assert [q0 for q0, _ in plan] == list(range(0, sq, bq))
    for q0, tiles in plan:
        rows = vis[q0:q0 + bq]
        k0s = [k0 for k0, _ in tiles]
        assert k0s == sorted(set(k0s)) and all(k0 % bk == 0 for k0 in k0s)
        seen = np.zeros(skv, bool)
        for k0, interior in tiles:
            block = np.zeros((rows.shape[0], bk), bool)
            part = rows[:, k0:k0 + bk]
            block[:, :part.shape[1]] = part
            assert block.any(), (q0, k0)
            assert interior == bool(block.all()), (q0, k0, interior)
            seen[k0:k0 + bk] = True
        assert not (rows & ~seen[None, :]).any(), q0


PLAN_EDGES = [
    (1, 1, 1, 0), (64, 64, 64, 0), (130, 130, 1, 0),      # W = 1
    (131, 131, 50, 0),                                     # ragged, W < BK
    (200, 200, 100, 0),                                    # W not k * BK
    (1000, 1000, 5000, 0), (45, 45, 1000, 0),              # W >= S
    (37, 300, 128, 263), (1, 517, 64, 516),                # q_offset > 0
    (40, 200, 64, 160), (33, 50, 7, 60),                   # rows see nothing
    (6144, 6144, 4096, 0),                                 # h2o-danube layer
]


@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("sq,skv,window,q_offset", PLAN_EDGES, ids=str)
def test_tile_plan_covers_the_band_and_masks_only_edges(sq, skv, window,
                                                        q_offset, bq):
    _assert_plan_holds(sq, skv, window, q_offset, bq, tswa.KEY_TILE)


@settings(max_examples=60, deadline=None)
@given(sq=st.integers(1, 300), extra=st.integers(0, 200),
       window=st.integers(1, 400), bk=st.sampled_from([16, 64, 128]),
       bq=st.sampled_from([16, 64, 128]), offset_frac=st.floats(0, 1))
def test_tile_plan_holds_on_random_shapes(sq, extra, window, bk, bq,
                                          offset_frac):
    """The plan's properties over ragged Sq and Skv, W below, above and
    not a multiple of the key tile, and 0 <= q_offset <= Skv - 1."""
    skv = sq + extra
    q_offset = int(offset_frac * extra)
    _assert_plan_holds(sq, skv, window, q_offset, bq, bk)


def test_tile_plan_of_the_cta_covers_its_warpgroups():
    """A bf16 CTA loads the tiles of its 128 rows; each of its two
    64-row warpgroups visits a subset of them."""
    for sq, skv, window, q_offset in PLAN_EDGES:
        cta = dict(tswa.swa_tile_plan(sq, skv, window, q_offset, 128))
        for q0, tiles in tswa.swa_tile_plan(sq, skv, window, q_offset, 64):
            assert {k for k, _ in tiles} <= {k for k, _ in cta[q0 - q0 % 128]}


def _plan_replay(q, k, v, window, q_offset, bq=64, bk=64):
    """The kernels' online softmax over the tile plan, in fp32 on the
    host: masks only on tiles the plan does not call interior, exp2 with
    the scale and log2 e folded in, a row that sees nothing is 0."""
    sq, d = q.shape
    skv = k.shape[0]
    c = d ** -0.5 * np.log2(np.e)
    out = np.zeros_like(q)
    vis = _visible(sq, skv, window, q_offset)
    for q0, tiles in tswa.swa_tile_plan(sq, skv, window, q_offset, bq, bk):
        rows = slice(q0, min(q0 + bq, sq))
        m = np.full(rows.stop - q0, -1e30, np.float32)
        l = np.zeros_like(m)
        acc = np.zeros((rows.stop - q0, d), np.float32)
        for k0, interior in tiles:
            keys = slice(k0, min(k0 + bk, skv))
            s = q[rows] @ k[keys].T
            if not interior:
                s = np.where(vis[rows, keys], s, np.float32(-1e30))
            m_new = np.maximum(m, s.max(1))
            alpha = np.exp2((m - m_new) * c)
            p = np.exp2(s * c - (m_new * c)[:, None])
            if not interior:
                p = np.where(s > -5e29, p, 0)
            l = l * alpha + p.sum(1)
            acc = acc * alpha[:, None] + p @ v[keys]
            m = m_new
        out[rows] = acc / np.maximum(l, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("sq,skv,window,q_offset", PLAN_EDGES[:-1], ids=str)
def test_plan_replay_matches_the_reference(sq, skv, window, q_offset):
    """Skipping the mask on interior tiles changes nothing: the replay
    equals the JAX reference (fp32) within 1e-5, and a row that sees no
    key (where the reference's softmax is NaN) is 0."""
    q, k, v = (x[0, 0] for x in _qkv(1, 1, 1, sq, skv, 32, seed=sq + window))
    want = np.asarray(jref.swa_attention_ref(
        *(jnp.asarray(x[None, None]) for x in (q, k, v)), window=window,
        q_offset=q_offset)[0, 0])
    got = _plan_replay(q, k, v, window, q_offset)
    blind = ~_visible(sq, skv, window, q_offset).any(1)
    assert (got[blind] == 0).all() and np.isnan(want[blind]).all()
    _close(got[~blind], want[~blind], TOL)


# -------------- the dK/dV kernels' transposed tile plan --------------- #
def _assert_key_plan_holds(sq, skv, window, q_offset, keys, bk, bq):
    """Every key tile with a key below Skv is listed once, in order; every
    visible pair lies in a visited tile pair; every visited pair holds a
    visible pair; an interior one is wholly visible and ends inside Skv;
    a masked one holds an invisible pair (keys past Skv count as
    invisible, query rows past Sq as absent)."""
    vis = _visible(sq, skv, window, q_offset)
    plan = tswa.swa_key_tile_plan(sq, skv, window, q_offset, keys, bk, bq)
    assert [k0 for k0, _ in plan] == list(range(0, skv, bk))
    for k0, tiles in plan:
        cols = np.zeros((sq, bk), bool)
        part = vis[:, k0:k0 + bk]
        cols[:, :part.shape[1]] = part
        q0s = [q0 for q0, _ in tiles]
        assert q0s == sorted(set(q0s)) and all(q0 % bq == 0 for q0 in q0s)
        seen = np.zeros(sq, bool)
        for q0, interior in tiles:
            block = cols[q0:q0 + bq]
            assert block.any(), (k0, q0)
            assert interior == bool(block.all()), (k0, q0, interior)
            seen[q0:q0 + bq] = True
        assert not (cols & ~seen[:, None]).any(), k0


#: the forward's edges, then a 128-key CTA whose second warpgroup lies
#: past Skv (178, 129: one real key), and q_offset > 0 with Sq < Skv and
#: Skv ragged
KEY_PLAN_EDGES = PLAN_EDGES + [
    (178, 178, 100, 0), (129, 129, 77, 0), (150, 330, 64, 180),
    (64, 300, 200, 236),
]


@pytest.mark.parametrize("keys", [64, 128])
@pytest.mark.parametrize("sq,skv,window,q_offset", KEY_PLAN_EDGES, ids=str)
def test_tile_plan_of_the_keys_covers_the_band_and_masks_only_edges(
        sq, skv, window, q_offset, keys):
    _assert_key_plan_holds(sq, skv, window, q_offset, keys, tswa.KEY_TILE,
                           tswa.PLAN_ROWS)


@settings(max_examples=60, deadline=None)
@given(sq=st.integers(1, 300), extra=st.integers(0, 200),
       window=st.integers(1, 400), keys=st.sampled_from([64, 128]),
       bq=st.sampled_from([16, 64]), offset_frac=st.floats(0, 1))
def test_tile_plan_of_the_keys_holds_on_random_shapes(sq, extra, window,
                                                      keys, bq, offset_frac):
    """The transposed plan's properties over ragged Sq and Skv, W below,
    above and not a multiple of the tiles, and 0 <= q_offset <= Skv - 1."""
    skv = sq + extra
    q_offset = int(offset_frac * extra)
    _assert_key_plan_holds(sq, skv, window, q_offset, keys, 64, bq)


@pytest.mark.parametrize("sq,skv,window,q_offset", KEY_PLAN_EDGES, ids=str)
def test_tile_plan_of_a_key_cta_is_that_of_its_warpgroups(sq, skv, window,
                                                          q_offset):
    """A 128-key CTA streams the query tiles of all its keys; each of its
    warpgroups visits exactly those a 64-key CTA of its own would."""
    assert (tswa.swa_key_tile_plan(sq, skv, window, q_offset, 128)
            == tswa.swa_key_tile_plan(sq, skv, window, q_offset, 64))
    assert tswa.dkdv_keys(80) == 128 and tswa.dkdv_keys(128) == 64
    assert tswa.dkdv_keys(256) == 64


@pytest.mark.parametrize("d", tswa.HEAD_DIMS)
def test_fp32_backward_plans_walk_its_query_tiles(d):
    """The fp32 backward kernels walk ``f32_backward_rows(d)``-query tiles
    (32 at d = 256, where 64-row tiles of Q, dO, K and V do not fit
    shared memory; ``f32_bwd_rows`` in the source): the key plan and the
    dQ plan at that ``bq`` cover the band on the key plan's edges."""
    from repro_torch.kernels import _build
    bq = tswa.f32_backward_rows(d)
    assert bq == (32 if d == 256 else tswa.PLAN_ROWS)
    text = (_build.CSRC / "swa_attention.cu").read_text()
    assert "return hd > 128 ? 32 : BWD_BQ;" in text
    for sq, skv, window, q_offset in KEY_PLAN_EDGES:
        _assert_key_plan_holds(sq, skv, window, q_offset, tswa.KEY_TILE,
                               tswa.KEY_TILE, bq)
        _assert_plan_holds(sq, skv, window, q_offset, bq, tswa.KEY_TILE)


def _saved(q, k, v, window, q_offset):
    """The forward's saved output and log-sum-exp of one (Sq, d) head, as
    the kernel writes them: the plain versions, a row that sees no key 0
    (the plain softmax gives NaN there)."""
    tq, tk, tv = _t(q[None, None], k[None, None], v[None, None])
    o = tref.swa_attention_ref(tq, tk, tv, window, q_offset)
    return (torch.nan_to_num(o, nan=0.0),
            tref.swa_attention_lse_ref(tq, tk, window, q_offset))


def _key_plan_replay(q, k, v, do, window, q_offset, keys=128, bq=64,
                     bk=64):
    """dK and dV as the dK/dV kernels compute them, in fp32 on the host,
    over the transposed plan: P^T = 2^(S^T c - lse c) with lse per
    column, masks only on tiles the plan does not call interior, query
    rows past Sq padded with zeros, lse = +inf and D = 0."""
    sq, d = q.shape
    skv = k.shape[0]
    c = np.float32(d ** -0.5 * np.log2(np.e))
    vis = _visible(sq, skv, window, q_offset)
    o, lse = (x[0, 0].numpy() for x in _saved(q, k, v, window, q_offset))
    n = -(-sq // bq) * bq
    pad = lambda x, fill: np.concatenate(
        [x, np.full((n - sq,) + x.shape[1:], fill, np.float32)])
    qp, dop = pad(q, 0), pad(do, 0)
    l2 = pad((lse * np.log2(np.e)).astype(np.float32), np.inf)
    dd = pad((do * o).sum(1), 0)
    visp = np.concatenate([vis, np.zeros((n - sq, skv), bool)])
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    with np.errstate(over="ignore", invalid="ignore"):
        for k0, tiles in tswa.swa_key_tile_plan(sq, skv, window, q_offset,
                                                keys, bk, bq):
            ks = slice(k0, min(k0 + bk, skv))
            for q0, interior in tiles:
                rs = slice(q0, q0 + bq)
                p = np.exp2(k[ks] @ qp[rs].T * c - l2[rs][None, :])
                if not interior:
                    p = np.where(visp[rs, ks].T, p, 0)
                ds = p * (v[ks] @ dop[rs].T - dd[rs][None, :])
                dv[ks] += p @ dop[rs]
                dk[ks] += ds @ qp[rs]
    return dk * np.float32(d ** -0.5), dv


@pytest.mark.parametrize("sq,skv,window,q_offset", KEY_PLAN_EDGES[:-2],
                         ids=str)
def test_key_plan_replay_matches_the_plain_backward(sq, skv, window,
                                                   q_offset):
    """Skipping the mask on interior tile pairs and padding rows past Sq
    with lse = +inf changes nothing: the replay's dK and dV equal the
    plain backward's (fp32) within 2e-4, keys no query sees are 0."""
    q, k, v = (x[0, 0] for x in _qkv(1, 1, 1, sq, skv, 16, seed=sq + skv))
    do = _do(1, 1, sq, 16, seed=window)[0, 0]
    got_dk, got_dv = _key_plan_replay(q, k, v, do, window, q_offset)
    tq, tk, tv, tdo = _t(q[None, None], k[None, None], v[None, None],
                         do[None, None])
    _, want_dk, want_dv = tref.swa_attention_backward_ref(
        tq, tk, tv, *_saved(q, k, v, window, q_offset), tdo, window,
        q_offset)
    _close(got_dk, want_dk[0, 0], PALLAS_TOL)
    _close(got_dv, want_dv[0, 0], PALLAS_TOL)
    unseen = ~_visible(sq, skv, window, q_offset).any(0)
    assert (got_dk[unseen] == 0).all() and (got_dv[unseen] == 0).all()


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


#: the card's extra cases: d = 16 and 128, ragged Sq with q_offset, W
#: not a multiple of the key tile, Skv not a multiple of it
CARD_CASES = REF_CASES + [
    (1, 2, 1, 200, 461, 16, 100, 300),
    (1, 4, 2, 333, 1000, 128, 200, 700),
    (2, 2, 1, 190, 190, 128, 77, 0),
    (1, 2, 2, 70, 333, 16, 1000, 263),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version on the card; skips on
    machines without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    tswa.reset_launches()
    for B, hq, hkv, sq, skv, d, W, off in CARD_CASES:
        q, k, v = (torch.from_numpy(_fold(x)).cuda().to(dt)
                   for x in _qkv(B, hq, hkv, sq, skv, d))
        got = tswa.swa_attention_forward(q, k, v, W, off).float()
        want = tref.swa_attention_ref(q[None], k[None], v[None], W,
                                      off)[0].float()
        tol = PALLAS_TOL if dt == torch.float32 else 1e-2 * (1 + want.abs())
        assert bool(((got - want).abs() <= tol).all())
    assert tswa.launches["swa_attention_forward"] == len(CARD_CASES)


# ------------------------------ backward ------------------------------ #
#: (B, Hq, Hkv, Sq, Skv, d, window, q_offset): d in {16, 32, 64, 80}, GQA
#: ratios 1, 4 and 8, W < S and W >= S, ragged S, and q_offset with
#: Sq < Skv (the kernel's meaning; the scan is held only at q_offset 0)
BWD_CASES = [
    (1, 2, 2, 48, 48, 16, 16, 0),          # ratio 1, W < S
    (2, 4, 1, 40, 40, 32, 64, 0),          # ratio 4, W >= S
    (1, 8, 1, 37, 37, 64, 10, 0),          # ratio 8, ragged, W < S
    (1, 4, 1, 70, 70, 80, 33, 0),          # h2o's d, ragged
    (2, 8, 1, 65, 65, 80, 100, 0),         # ratio 8, W >= S
    (1, 4, 2, 20, 60, 32, 24, 40),         # q_offset, Sq < Skv
    (2, 4, 4, 80, 80, 64, 64, 0),          # reduced h2o: S wraps W
]


def _do(B, hq, sq, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, hq, sq, d), dtype=np.float32)


def _jax_vjp_ref(q, k, v, do, W, off):
    """``jax.vjp`` of ``repro.kernels.ref.swa_attention_ref``."""
    _, vjp = jax.vjp(lambda a, b, c: jref.swa_attention_ref(
        a, b, c, window=W, q_offset=off), *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(do))


def _lse_numpy(q, k, W, off):
    """Each query's log-sum-exp over the keys it sees, in float64."""
    B, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kk = np.repeat(k.astype(np.float64), g, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) * d ** -0.5
    s = np.where(_visible(sq, k.shape[2], W, off), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case):
    """The port's plain backward, unfolded (``ref``) and folded through the
    wrapper, against ``jax.vjp`` of the reference's plain function, from
    the port's plain output and log-sum-exp; the log-sum-exp against an
    independent float64 one."""
    B, hq, hkv, sq, skv, d, W, off = case
    q, k, v = _qkv(B, hq, hkv, sq, skv, d, seed=sq + d + W)
    do = _do(B, hq, sq, d, seed=d)
    want = _jax_vjp_ref(q, k, v, do, W, off)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o = tref.swa_attention_ref(tq, tk, tv, W, off)
    lse = tref.swa_attention_lse_ref(tq, tk, W, off)
    assert lse.shape == (B, hq, sq) and lse.dtype == torch.float32
    _close(lse, _lse_numpy(q, k, W, off), TOL)
    for got, w in zip(tref.swa_attention_backward_ref(
            tq, tk, tv, o, lse, tdo, W, off), want):
        _close(got, w, PALLAS_TOL)
    folded = tswa.swa_attention_backward(
        *(_fold(x) for x in (tq, tk, tv, o)), _fold(lse), _fold(tdo), W, off)
    for got, w in zip(folded, want):
        _close(got.reshape(w.shape), w, PALLAS_TOL)


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[-1] == 0],
                         ids=str)
def test_model_swa_backward_matches_jax_scan(case):
    """Gradients through ``models/attention.py``'s ``swa_attention`` (the
    grouped layout, ``SWAAttentionFn`` on CPU tensors) against ``jax.vjp``
    of the zoo's jnp scan, the function the reference trains through."""
    B, hq, hkv, S, _, d, W, _ = case
    q, k, v = _grouped(B, S, S, hkv, hq // hkv, d, seed=S * d)
    do = np.random.default_rng(W).standard_normal(q.shape, dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn.swa_attention(
        a, b, c, window=W, chunk_q=32), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = tattn.swa_attention(tq, tk, tv, window=W)
    out.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, PALLAS_TOL)


@pytest.mark.parametrize("case", BWD_CASES[::2], ids=str)
def test_autograd_function_on_cpu_is_the_plain_backward(case):
    """``SWAAttentionFn`` on CPU tensors: its output is the plain forward
    and its gradients are the plain backward's, bit for bit; both equal
    autograd through the plain forward within 1e-5."""
    B, hq, hkv, sq, skv, d, W, off = case
    q, k, v = (torch.from_numpy(_fold(x)) for x in _qkv(
        B, hq, hkv, sq, skv, d, seed=W))
    do = torch.from_numpy(_fold(_do(B, hq, sq, d, seed=sq)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tswa.SWAAttentionFn.apply(*leaves, W, off)
    out.backward(do)
    o, lse = tswa.swa_attention_forward(q, k, v, W, off, return_lse=True)
    assert torch.equal(out.detach(), o)
    want = tswa.swa_attention_backward(q, k, v, o, lse, do, W, off)
    auto = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tref.swa_attention_ref(*(x[None] for x in auto), W, off)[0].backward(do)
    for leaf, w, a in zip(leaves, want, auto):
        assert torch.equal(leaf.grad, w)
        _close(leaf.grad, a.grad, TOL)


def test_prefill_under_no_grad_takes_the_forward_without_lse():
    """With grad enabled and inputs that want it, ``models/attention.py``
    builds a graph through ``SWAAttentionFn``; under ``no_grad`` (prefill)
    it does not."""
    def nodes(fn):
        """The names of the graph's nodes below ``fn``."""
        seen, todo = set(), [fn]
        while todo:
            f = todo.pop()
            if f is not None and type(f).__name__ not in seen:
                seen.add(type(f).__name__)
                todo += [g for g, _ in f.next_functions]
        return seen

    q, k, v = (x.requires_grad_(True) for x in _t(*_grouped(1, 20, 20, 2, 2,
                                                          16, seed=1)))
    out = tattn.swa_attention(q, k, v, window=8)
    assert tswa.SWAAttentionFn._backward_cls.__name__ in nodes(out.grad_fn)
    with torch.no_grad():
        assert tattn.swa_attention(q, k, v, window=8).grad_fn is None


@pytest.mark.parametrize("bad", ["o_shape", "lse_dtype", "do_dtype"])
def test_backward_rejects_mismatched_saved_tensors(bad):
    q, k, v = torch.zeros(4, 16, 32), torch.zeros(2, 16, 32), \
        torch.zeros(2, 16, 32)
    o, lse, do = torch.zeros(4, 16, 32), torch.zeros(4, 16), \
        torch.zeros(4, 16, 32)
    if bad == "o_shape":
        o = o[:, :8]
    elif bad == "lse_dtype":
        lse = lse.double()
    else:
        do = do.to(torch.bfloat16)
    with pytest.raises(ValueError):
        tswa.swa_attention_backward(q, k, v, o, lse, do, 8)


#: the card's extra backward cases: d = 16 and 128, misaligned Sq and Skv
#: with q_offset > 0, W not a multiple of the key tile, rows that see no
#: key (Skv short of q_offset + Sq), and reduced h2o's training shape
BWD_CARD_CASES = BWD_CASES + [
    (1, 2, 1, 200, 461, 16, 100, 300),
    (1, 4, 2, 333, 1000, 128, 200, 700),
    (2, 2, 1, 190, 190, 128, 77, 0),
    (1, 4, 2, 100, 130, 64, 40, 60),
    (2, 4, 2, 96, 96, 64, 64, 0),
    # the bf16 dK/dV tiling's edges: a 128-key CTA half past Skv (group 1;
    # one real key at 129), group 8, and d = 16, 32, 128 at W not a
    # multiple of 64
    (1, 2, 2, 178, 178, 80, 100, 0),
    (1, 8, 1, 300, 300, 80, 150, 0),
    (1, 4, 2, 150, 150, 16, 100, 0),
    (2, 4, 1, 129, 129, 32, 77, 0),
    (1, 4, 2, 190, 250, 128, 130, 60),
]


def _card_bwd_inputs(case, dt):
    B, hq, hkv, sq, skv, d, W, off = case
    q, k, v = (torch.from_numpy(_fold(x)).cuda().to(dt)
               for x in _qkv(B, hq, hkv, sq, skv, d, seed=sq + skv))
    do = torch.from_numpy(_fold(_do(B, hq, sq, d, seed=d))).cuda().to(dt)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_on_card(dtype):
    """The forward's log-sum-exp and the three backward kernels against the
    plain versions on the card, on the same saved tensors; one launch of
    each entry point a case; skips on machines without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    tswa.reset_launches()
    for B, hq, hkv, sq, skv, d, W, off in BWD_CARD_CASES:
        q, k, v, do = _card_bwd_inputs((B, hq, hkv, sq, skv, d, W, off), dt)
        o, lse = tswa.swa_attention_forward(q, k, v, W, off, return_lse=True)
        lse_p = tref.swa_attention_lse_ref(q[None], k[None], W, off)[0]
        seen = torch.isfinite(lse_p)
        assert torch.equal(torch.isfinite(lse), seen)
        assert bool(((lse - lse_p).abs()[seen]
                     <= PALLAS_TOL * (1 + lse_p.abs()[seen])).all())
        o_p = tref.swa_attention_ref(q[None], k[None], v[None], W, off)[0]
        got = tswa.swa_attention_backward(q, k, v, o_p, lse_p, do, W, off)
        want = tref.swa_attention_backward_ref(
            q[None], k[None], v[None], o_p[None], lse_p[None], do[None], W,
            off)
        for g, w in zip(got, want):
            g, w = g.float(), w[0].float()
            tol = PALLAS_TOL if dt == torch.float32 else 1e-2 * (1 + w.abs())
            assert g.dtype == torch.float32 and bool(
                ((g - w).abs() <= tol).all())
    n = len(BWD_CARD_CASES)
    assert tswa.launches == {"swa_attention_forward": n,
                             "swa_attention_bwd_dot": n,
                             "swa_attention_backward_dkdv": n,
                             "swa_attention_backward_dq": n}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_give_the_same_bits_twice(dtype):
    """No atomics: two backward launches on the same inputs are equal bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    for case in (BWD_CARD_CASES[4], BWD_CARD_CASES[8]):
        q, k, v, do = _card_bwd_inputs(case, dt)
        W, off = case[6], case[7]
        o, lse = tswa.swa_attention_forward(q, k, v, W, off, return_lse=True)
        first = tswa.swa_attention_backward(q, k, v, o, lse, do, W, off)
        second = tswa.swa_attention_backward(q, k, v, o, lse, do, W, off)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
