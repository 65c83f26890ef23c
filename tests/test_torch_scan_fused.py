"""The fused selective scan (``kernels.selective_scan_fused``) of the port.

No JAX here: the reference's own tail of ``mamba_apply`` is held to the
plain version in ``tests/test_torch_mamba.py``.

- In bf16 the plain version equals, bit for bit, the chain the Mamba
  block ran before the fusion (``layers.dense`` with dt_proj's bias, fp32
  softplus, the stepwise scan chunk by chunk, the D skip, the gate, the
  cast), since the two packages round bf16 at other places and the port
  must not move them; in fp32 too.
- The wrapper's shape and dtype checks raise, on the CPU as on the card.
- ``_mamba_inner`` reaches the fused wrapper once a layer, with z the
  second half of in_proj's output (a strided view, no copy) and dt before
  dt_proj's bias.
- The ``cuda`` test holds the kernel to the plain version on the card; it
  skips here.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss
from repro_torch.models import blocks as tblocks
from repro_torch.models.config import ArchConfig, SSMConfig
from repro_torch.models.layers import dense

#: the kernel against the plain version (chip_smoke's): rtol = atol = 2e-4
#: on h_last and out, plus one bf16 ulp on a bf16 out
CARD_TOL = 2e-4
BF16_ULP = 2.0 ** -7


def _inputs(B, S, d_in, st, seed, dtype=torch.float32, h0_zero=True):
    """``(h0, dt, Bm, Cm, A, xc, D, z, dt_bias)`` as the block passes
    them: dt before its bias, Bm and Cm column slices of x_proj's output,
    z the second half of in_proj's output; made by numpy from a seed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    dtr = 5
    dbc = f(B, S, dtr + 2 * st).to(dtype)
    Bm, Cm = dbc[..., dtr:dtr + st], dbc[..., dtr + st:]
    xz = f(B, S, 2 * d_in).to(dtype)
    dt = (f(B, S, d_in) * 2.0).to(dtype)
    A = -torch.arange(1, st + 1, dtype=torch.float32).expand(d_in, st) \
        * torch.exp(0.1 * f(d_in, st))
    h0 = None if h0_zero else f(B, d_in, st)
    return h0, dt, Bm, Cm, A, f(B, S, d_in).to(dtype), f(d_in), \
        xz[..., d_in:], (f(d_in) * 0.5).to(dtype)


def _unfused_chain(h0, dt, Bm, Cm, A, xc, D, z, dt_bias, chunk):
    """The Mamba block's tail as it ran before the fusion: ``dense``'s bias
    add in the model dtype, fp32 softplus, the stepwise scan chunk by
    chunk from the state, the D skip and the gate in fp32, the cast."""
    B, S, d_in = xc.shape
    dtf = F.softplus((dt + dt_bias).float())
    h = torch.zeros((B, d_in, A.shape[1])) if h0 is None else h0
    c = min(chunk, S)
    ys = []
    for t0 in range(0, S, c):
        cut = slice(t0, t0 + c)
        h, y = tref.selective_scan(h, dtf[:, cut], Bm[:, cut], Cm[:, cut],
                                   A, xc[:, cut])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + D * xc.float()
    return h, (y * F.silu(z.float())).to(xc.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,chunk,h0_zero", [
    (24, 256, True), (300, 256, False), (1, 256, False), (40, 16, True)])
def test_plain_fused_equals_the_unfused_chain_bit_for_bit(dtype, S, chunk,
                                                          h0_zero):
    args = _inputs(2, S, 64, 8, seed=S + chunk, dtype=dtype,
                   h0_zero=h0_zero)
    h, out = tref.selective_scan_fused(*args, chunk=chunk)
    h_want, out_want = _unfused_chain(*args, chunk=chunk)
    assert out.dtype == dtype and h.dtype == torch.float32
    assert torch.equal(h, h_want) and torch.equal(out, out_want)


def test_dense_bias_rounds_as_the_fused_plain_version():
    """The block hands the wrapper ``dt_r @ w`` and the bias apart: the
    plain version's add rounds as ``layers.dense`` does, bit for bit."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((6, 64), dtype=np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(64, dtype=np.float32)
                         ).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((2, 7, 6), dtype=np.float32)
                         ).to(torch.bfloat16)
    assert torch.equal(dense({"w": w, "b": b}, x), x @ w + b)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    args = list(_inputs(2, 33, 64, 4, seed=3, h0_zero=False))
    args[1].requires_grad_(True)
    tss.reset_launches()
    h, out = tss.selective_scan_fused(*args, chunk=16)
    (h.sum() + out.sum()).backward()
    assert args[1].grad is not None and torch.isfinite(args[1].grad).all()
    assert tss.launches == {"selective_scan_forward": 0,
                            "selective_scan_fused": 0,
                            "selective_scan_fused_backward": 0}
    h2, out2 = tref.selective_scan_fused(*args, chunk=16)
    assert torch.equal(h, h2) and torch.equal(out, out2)


@pytest.mark.parametrize("bad", ["z", "D", "dt_bias", "h0", "Cm",
                                 "z dtype", "dt dtype", "bias dtype"])
def test_fused_wrapper_rejects_what_does_not_fit(bad):
    args = list(_inputs(2, 8, 16, 4, seed=4, dtype=torch.bfloat16,
                        h0_zero=False))
    i, val = {"z": (7, args[7][:, :4]), "D": (6, args[6][:8]),
              "dt_bias": (8, args[8][:8]), "h0": (0, args[0][:1]),
              "Cm": (3, args[3][..., :3]),
              "z dtype": (7, args[7].float()),
              "dt dtype": (1, args[1].float()),
              "bias dtype": (8, args[8].float())}[bad]
    args[i] = val
    with pytest.raises(ValueError):
        tss.selective_scan_fused(*args)


@pytest.mark.parametrize("fn", [tss.selective_scan_fused,
                                tref.selective_scan_fused])
def test_fused_scan_requires_dt_proj_s_bias(fn):
    """dt_proj always has a bias (``mamba_init``): the fused scan takes it
    as a required argument, and a missing one is an error, not a zero."""
    args = list(_inputs(2, 8, 16, 4, seed=6))
    with pytest.raises(TypeError):
        fn(*args[:8])
    args[8] = None
    with pytest.raises(TypeError):
        fn(*args)


def test_bc_rows_are_taken_in_place_only_where_tma_can():
    """Bm | Cm side by side in x_proj's output on 16-byte rows are read in
    place (falcon-mamba's 256 + 32 columns); rows of the reference's test
    config (2 + 8 columns, 20 bytes) are copied."""
    st = 16
    dbc = torch.zeros((2, 5, 256 + 2 * st), dtype=torch.bfloat16)
    Bm, Cm = dbc[..., 256:256 + st], dbc[..., 256 + st:]
    bc, stride = tss._bc_rows(Bm, Cm)
    assert bc.data_ptr() == Bm.data_ptr() and stride == 256 + 2 * st
    dbc = torch.zeros((2, 5, 2 + 8), dtype=torch.bfloat16)
    bc, stride = tss._bc_rows(dbc[..., 2:6], dbc[..., 6:])
    assert stride == 8 and torch.equal(bc, dbc[..., 2:])
    # Bm and Cm apart: one copy of both
    Bm, Cm = torch.ones((2, 5, 4)), torch.zeros((2, 5, 4))
    bc, stride = tss._bc_rows(Bm, Cm)
    assert stride == 8 and torch.equal(bc, torch.cat([Bm, Cm], -1))


def test_mamba_inner_goes_through_the_fused_wrapper(monkeypatch):
    """One call a layer, z a view of in_proj's output at its 2 d_in row
    stride, dt before dt_proj's bias, the bias apart, h0 None (a prefill
    starts from zero); the block's output is the wrapper's."""
    cfg = ArchConfig(arch_id="ssm-t", family="ssm", n_layers=1, d_model=32,
                     n_heads=0, n_kv_heads=1, d_ff=0, vocab=64,
                     dtype="float32", attention="none",
                     ssm=SSMConfig(d_state=4, d_conv=4, expand=2))
    p = tblocks.mamba_init(torch.Generator().manual_seed(0), cfg)
    seen = []
    real = tss.selective_scan_fused

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(tblocks.scan_kernels, "selective_scan_fused", spy)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, 32), dtype=np.float32))
    y = tblocks.mamba_apply(p, x, cfg)
    assert len(seen) == 1
    (h0, dt, Bm, Cm, A, xc, D, z, dt_bias, chunk), _ = seen[0]
    d_in = 64
    assert h0 is None and chunk == 256
    assert z.stride(1) == 2 * d_in and z._base is not None
    assert dt_bias is p["dt_proj"]["b"] and D is p["D"]
    dt_r = dense(p["x_proj"], xc)[..., :2]        # dt_rank ceil(32 / 16)
    assert torch.equal(dt, dt_r @ p["dt_proj"]["w"])
    _, out = real(h0, dt, Bm, Cm, A, xc, D, z, dt_bias, chunk)
    assert torch.equal(y, dense(p["out_proj"], out))


# ------------------------------- the card ----------------------------- #
def _card_close(got, want, ulp=0.0):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs()
                 <= CARD_TOL + (CARD_TOL + ulp) * want.abs()).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card():
    """The fused kernel against the plain version on the card: d_state 4,
    8 and 16, S 24, 300, 1 and 257, fp32 and bf16, h0 zero and not;
    h_last and out within 2e-4 (1 + |plain|), plus
    one bf16 ulp on a bf16 out; two launches give the same bits; a
    gradient asked runs the forward and the backward kernel (their
    gradients against the plain backward: tests/test_torch_scan_backward.py).
    Skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tss.reset_launches()
    n = 0
    for B, S, d_in, st, h0_zero in (
            (2, 24, 64, 4, True), (2, 300, 512, 8, False),
            (1, 1, 32, 16, False), (2, 257, 1024, 16, True)):
        for dtype in (torch.float32, torch.bfloat16):
            args = [None if a is None else a.cuda() for a in _inputs(
                B, S, d_in, st, seed=S, dtype=dtype, h0_zero=h0_zero)]
            h, out = tss.selective_scan_fused(*args)
            h2, out2 = tss.selective_scan_fused(*args)
            hp, outp = tref.selective_scan_fused(*args)
            torch.cuda.synchronize()
            n += 2
            assert out.dtype == dtype
            assert torch.equal(h, h2) and torch.equal(out, out2)
            _card_close(h, hp)
            _card_close(out, outp,
                        BF16_ULP if dtype == torch.bfloat16 else 0.0)
    assert tss.launches == {"selective_scan_forward": 0,
                            "selective_scan_fused": n,
                            "selective_scan_fused_backward": 0}
    # a gradient asked goes through SelectiveScanFusedFn: the forward
    # with its tile states, then the backward kernel
    args[1] = args[1].float().requires_grad_(True)
    args[5], args[7] = args[5].float(), args[7].float()
    args[2], args[3] = args[2].float(), args[3].float()
    args[8] = args[8].float()
    tss.reset_launches()
    _, out = tss.selective_scan_fused(*args)
    out.sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(args[1].grad).all()
    assert tss.launches == {"selective_scan_forward": 0,
                            "selective_scan_fused": 1,
                            "selective_scan_fused_backward": 1}


_BWD_NAMES = ("dh0", "ddt", "dBm", "dCm", "dA", "dxc", "dD", "dz",
              "ddt_bias")
#: gradients with one value per input element; the others are sums over
#: channels, steps or sequences, held to CARD_TOL * max|plain|
_PER_ELEMENT = ("dh0", "ddt", "dxc", "dz")


@pytest.mark.cuda
def test_fused_backward_kernel_matches_plain_on_card():
    """The backward kernel against the plain backward
    (``ref.selective_scan_fused_backward``) on the card: d_state 4, 8 and
    16, S 24, 300, 1, 257, 40 and 33, fp32 and bf16, from h0 and from
    zeros, with and without a gradient of h_last; d_in 72 and 1,032 are
    multiples neither of a block's 32 channels nor of a cluster's 128
    (blocks past d_in pad the last cluster).  ddt, dxc, dz and dh0 within
    2e-4 (1 + |plain|) (plus one bf16 ulp on a bf16 one), the reduced dA, dD,
    ddt_bias, dBm and dCm within 2e-4 * max|plain| (plus one bf16 ulp of
    each value on a bf16 one): chip_smoke's tolerances.  The forward with
    its tile states gives the same bits as without; two backward launches
    the same bits.  Skips here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tss.reset_launches()
    n = 0
    for B, S, d_in, st, h0_zero in (
            (2, 24, 64, 4, True), (2, 300, 512, 8, False),
            (1, 1, 32, 16, False), (2, 257, 1024, 16, True),
            (2, 40, 72, 16, False), (2, 33, 1032, 4, True)):
        for dtype in (torch.float32, torch.bfloat16):
            args = [None if a is None else a.cuda() for a in _inputs(
                B, S, d_in, st, seed=S + 1, dtype=dtype, h0_zero=h0_zero)]
            rng = np.random.default_rng(S)
            dout = torch.from_numpy(rng.standard_normal(
                (B, S, d_in), dtype=np.float32)).to(dtype).cuda()
            dh_last = None if h0_zero else torch.from_numpy(
                rng.standard_normal((B, d_in, st), dtype=np.float32)).cuda()
            h, out, _ = tss.selective_scan_fused_forward(*args)
            h_s, out_s, states = tss.selective_scan_fused_forward(
                *args, save_states=True)
            got = tss.selective_scan_fused_backward(*args, dout, dh_last,
                                                    states)
            again = tss.selective_scan_fused_backward(*args, dout, dh_last,
                                                      states)
            want = tref.selective_scan_fused_backward(*args, dout, dh_last)
            torch.cuda.synchronize()
            n += 1
            assert torch.equal(h, h_s) and torch.equal(out, out_s)
            for name, g, g2, w in zip(_BWD_NAMES, got, again, want):
                if w is None:
                    assert g is None and g2 is None, name
                    continue
                assert g.dtype == w.dtype and torch.equal(g, g2), name
                ulp = BF16_ULP if w.dtype == torch.bfloat16 else 0.0
                if name in _PER_ELEMENT:
                    _card_close(g, w, ulp)
                    continue
                g, w = g.float().cpu(), w.float().cpu()
                assert bool(((g - w).abs() <= CARD_TOL * w.abs().max()
                             + ulp * w.abs()).all()), name
    assert tss.launches == {"selective_scan_forward": 0,
                            "selective_scan_fused": 2 * n,
                            "selective_scan_fused_backward": 2 * n}
