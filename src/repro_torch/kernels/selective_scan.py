"""Mamba's selective scan, forward and backward: the wrappers around
``csrc/selective_scan.cu``.

The JAX package has no Pallas kernel here: it runs the scan in jnp, a
log-depth associative scan over 256-step chunks under ``lax.scan``
(``repro.models.blocks._selective_scan_chunk``), and the layer's tail
around it (softplus of dt, the D skip, the silu(z) gate) as jnp passes,
and differentiates all of it with ``jax.value_and_grad``.  At
falcon-mamba-7b's width that form, or a plain loop of PyTorch ops over
2,048 steps, costs seconds a prefill; one launch of the kernel runs a
layer's whole sequence with the state in registers.

Three entry points:

- :func:`selective_scan_fused`, the main path (``models.blocks``): dt
  before ``dt_proj``'s bias and softplus, xc, z, Bm and Cm in
  the model's dtype, returns ``(h_last fp32, out)`` with out in the model
  dtype, ``(y + D xc) * silu(z)``.  Its contract is
  :func:`repro_torch.kernels.ref.selective_scan_fused`.  With a gradient
  asked it goes through :class:`SelectiveScanFusedFn`: the forward also
  saves each 16-step tile's starting state, and the backward kernel
  (:func:`selective_scan_fused_backward`, contract
  :func:`repro_torch.kernels.ref.selective_scan_fused_backward`) gives
  every input's gradient.
- :func:`selective_scan`, the bare scan: dt softplus'd in fp32, returns
  ``(h_last, y)`` in fp32.  Its contract is
  :func:`repro_torch.kernels.ref.selective_scan` (fp32, step by step).
  No path differentiates it: on the card a gradient asked of it raises
  ``NotImplementedError`` (ROADMAP Queue 1 item 5(c'')).

On CPU tensors the plain versions run.  On CUDA tensors the kernels run
or the call raises: there is no switch and no fallback.  ``launches``
counts kernel launches by entry point.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref

#: the state sizes the kernel is built for: the reference's test config
#: (4), reduced falcon-mamba (8), falcon-mamba-7b (16)
D_STATES = (4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)
#: d_in must be a multiple of this on the card: the tensor maps take rows
#: on 16-byte boundaries (z's rows start d_in elements into in_proj's)
D_IN_MULTIPLE = 8

#: steps a tile of the kernels (``T`` in the source): the forward saves
#: each tile's starting state for the backward
TILE = 16
#: channels a block of the kernels (``CPB``)
CHANNELS_PER_BLOCK = 32
#: blocks of the backward's thread-block cluster (``BWD_CLUSTER``), along
#: the channels: it writes its partial sums over channels (dBm | dCm) one
#: row a cluster, ``CHANNELS_PER_PARTIAL`` channels
BWD_CLUSTER = 4
CHANNELS_PER_PARTIAL = CHANNELS_PER_BLOCK * BWD_CLUSTER

_LIB = _build.Library("selective_scan", {
    # dt, x, bc, A, h0, y, h_last, B, S, d_in, st, bc_stride, is_bf16,
    # stream
    "selective_scan_forward": 14,
    # dt, x, z, bc, A, h0, D, dt_bias, out, h_last, states, B, S, d_in,
    # st, bc_stride, z_stride, is_bf16, stream
    "selective_scan_fused": 19,
    # dt, x, z, bc, A, D, dt_bias, dout, dh_last, states, ddt, dx, dz,
    # dbc_part, red_part, dh0, B, S, d_in, st, bc_stride, z_stride,
    # is_bf16, stream
    "selective_scan_fused_backward": 24,
})
#: kernel launches by entry point since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset

_NO_GRAD_MSG = ("the bare scan has no backward kernel (ROADMAP Queue 1 item "
                "5(c''): no path differentiates it); the fused entry point "
                "has one, and the plain version's gradient runs on CPU "
                "tensors")


def _check(h0: Optional[torch.Tensor], dt: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor,
           **more: Tuple[torch.Tensor, tuple]) -> None:
    if dt.dim() != 3:
        raise ValueError(f"dt must be (B, S, d_in), got {tuple(dt.shape)}")
    B, S, d_in = dt.shape
    st = A.shape[-1] if A.dim() == 2 else -1
    want = {"xc": (xc, (B, S, d_in)), "Bm": (Bm, (B, S, st)),
            "Cm": (Cm, (B, S, st)), "A": (A, (d_in, st)),
            "h0": (h0, (B, d_in, st))}
    want.update(more)
    for name, (t, shape) in want.items():
        if t is None and name == "h0":          # a zero state
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)} for dt "
                             f"{tuple(dt.shape)}, got {tuple(t.shape)}")
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _card_checks(dt: torch.Tensor, A: torch.Tensor, xc: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> None:
    B, _, d_in = dt.shape
    st = A.shape[1]
    if st not in D_STATES:
        raise ValueError(f"d_state {st} not in {D_STATES}")
    if xc.dtype not in DTYPES or Bm.dtype != xc.dtype \
            or Cm.dtype != xc.dtype:
        raise ValueError(f"xc, Bm and Cm must share one dtype of {DTYPES}, "
                         f"got {xc.dtype}, {Bm.dtype}, {Cm.dtype}")
    if d_in % D_IN_MULTIPLE:
        raise ValueError(f"d_in {d_in} is not a multiple of "
                         f"{D_IN_MULTIPLE} (the kernel's tensor maps)")
    if B > 65535:
        raise ValueError(f"batch {B} past the grid's y limit of 65535")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary (a copy otherwise)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows_in_place(t: torch.Tensor) -> bool:
    """(B, S, n) with its n values contiguous and each (b, t) row a fixed
    stride apart, on 16-byte boundaries: a TMA map takes it as it is."""
    es = t.element_size()
    return (t.stride(2) == 1 and t.stride(0) == t.shape[1] * t.stride(1)
            and t.data_ptr() % 16 == 0 and (t.stride(1) * es) % 16 == 0)


def _bc_rows(Bm: torch.Tensor, Cm: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Bm | Cm as one run of 2 st values a (b, t) row: in place where Cm
    sits right after Bm in one tensor (x_proj's output), a copy otherwise.
    Returns the tensor whose data_ptr starts the first row, and the row
    stride in elements."""
    st = Bm.shape[-1]
    if (_rows_in_place(Bm) and Cm.stride() == Bm.stride()
            and Cm.data_ptr() == Bm.data_ptr() + st * Bm.element_size()
            and Bm.stride(1) >= 2 * st):
        return Bm, Bm.stride(1)
    bc = torch.cat([Bm, Cm], dim=-1).contiguous()
    return bc, bc.stride(1)


def selective_scan(h0: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_last (B, d_in, st), y (B, S, d_in))`` fp32 of the scan over the
    S steps of ``dt`` from ``h0``; one kernel launch on the card.

    dt (B, S, d_in) and A (d_in, st) are taken in fp32 (softplus'd dt,
    ``A = -exp(A_log)``), xc (B, S, d_in), Bm and Cm (B, S, st) in the
    model's dtype (fp32 or bf16); Bm and Cm may be column slices of one
    (B, S, n) tensor, as ``mamba_*`` cut them from ``x_proj``'s output."""
    _check(h0, dt, Bm, Cm, A, xc)
    if dt.device.type == "cpu":
        return ref.selective_scan(h0, dt, Bm, Cm, A, xc)
    if _wants_grad((h0, dt, Bm, Cm, A, xc)):
        raise NotImplementedError(f"selective_scan: {_NO_GRAD_MSG}")
    _card_checks(dt, A, xc, Bm, Cm)
    B, S, d_in = dt.shape
    st = A.shape[1]
    dt, A, h0 = (_aligned(t.float()) for t in (dt, A, h0))
    xc = _aligned(xc)
    bc, bc_stride = _bc_rows(Bm, Cm)
    with _build.on_device(dt.device):
        y = torch.empty((B, S, d_in), dtype=torch.float32, device=dt.device)
        h_last = torch.empty((B, d_in, st), dtype=torch.float32,
                             device=dt.device)
        _LIB.launch("selective_scan_forward", dt.data_ptr(), xc.data_ptr(),
                    bc.data_ptr(), A.data_ptr(), h0.data_ptr(),
                    y.data_ptr(), h_last.data_ptr(), B, S, d_in, st,
                    bc_stride, int(xc.dtype == torch.bfloat16),
                    _build.stream_handle(dt.device))
    return h_last, y


def _check_fused(h0, dt, Bm, Cm, A, xc, D, z, dt_bias, **more) -> None:
    _check(h0, dt, Bm, Cm, A, xc, z=(z, dt.shape), D=(D, dt.shape[2:]),
           dt_bias=(dt_bias, dt.shape[2:]), **more)
    for name, t in (("dt", dt), ("z", z), ("dt_bias", dt_bias)):
        if t.dtype != xc.dtype:
            raise ValueError(f"{name} is {t.dtype}, xc {xc.dtype}: the "
                             f"fused scan takes one model dtype")


def selective_scan_fused(h0: Optional[torch.Tensor], dt: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor,
                         xc: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                         dt_bias: torch.Tensor, chunk: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_last (B, d_in, st) fp32, out (B, S, d_in))``: a Mamba layer's
    softplus, scan, D skip and silu(z) gate; one kernel launch on the card.

    dt is ``dt_proj``'s product before its bias (``dt_bias`` (d_in,),
    added and rounded in the model's dtype as ``layers.dense`` does); dt,
    xc (B, S, d_in), z (B, S, d_in; read in place
    at its row stride, e.g. the second half of in_proj's output), Bm and
    Cm (B, S, st) share the model's dtype (fp32 or bf16), which ``out``
    takes; A (d_in, st) and D (d_in,) are fp32; h0 (B, d_in, st) fp32, or
    None for a zero state.  On the CPU the plain version scans ``chunk``
    steps at a time, as the reference does.  With grad enabled and an
    input that asks for one, the call is :class:`SelectiveScanFusedFn`'s
    (its gradient by the backward kernel on the card).  Either way the
    arguments are checked once, by :func:`selective_scan_fused_forward`."""
    if _wants_grad((h0, dt, Bm, Cm, A, xc, D, z, dt_bias)):
        return SelectiveScanFusedFn.apply(h0, dt, Bm, Cm, A, xc, D, z,
                                          dt_bias, chunk)
    return selective_scan_fused_forward(h0, dt, Bm, Cm, A, xc, D, z,
                                        dt_bias, chunk)[:2]


def selective_scan_fused_forward(h0: Optional[torch.Tensor],
                                 dt: torch.Tensor, Bm: torch.Tensor,
                                 Cm: torch.Tensor, A: torch.Tensor,
                                 xc: torch.Tensor, D: torch.Tensor,
                                 z: torch.Tensor, dt_bias: torch.Tensor,
                                 chunk: int = 256, save_states: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            Optional[torch.Tensor]]:
    """:func:`selective_scan_fused`'s forward, with no autograd:
    ``(h_last, out, states)``.  With ``save_states`` on the card the
    kernel also writes ``states`` (B, ceil(S / TILE), d_in, st) fp32, the
    state each tile starts from (h0, or zeros, for the first), which the
    backward kernel reads; otherwise, and on the CPU, ``states`` is
    None.  Without them the launch is the one of a prefill."""
    _check_fused(h0, dt, Bm, Cm, A, xc, D, z, dt_bias)
    if dt.device.type == "cpu":
        return (*ref.selective_scan_fused(h0, dt, Bm, Cm, A, xc, D, z,
                                          dt_bias, chunk), None)
    _card_checks(dt, A, xc, Bm, Cm)
    B, S, d_in = dt.shape
    st = A.shape[1]
    dt, xc = _aligned(dt), _aligned(xc)
    A, D = (_aligned(t.float()) for t in (A, D))
    h0 = None if h0 is None else _aligned(h0.float())
    dt_bias = _aligned(dt_bias)
    if not _rows_in_place(z):
        z = _aligned(z)
    bc, bc_stride = _bc_rows(Bm, Cm)
    with _build.on_device(dt.device):
        out = torch.empty((B, S, d_in), dtype=xc.dtype, device=dt.device)
        h_last = torch.empty((B, d_in, st), dtype=torch.float32,
                             device=dt.device)
        states = torch.empty((B, -(-S // TILE), d_in, st),
                             dtype=torch.float32, device=dt.device) \
            if save_states else None
        _LIB.launch("selective_scan_fused", dt.data_ptr(), xc.data_ptr(),
                    z.data_ptr(), bc.data_ptr(), A.data_ptr(),
                    0 if h0 is None else h0.data_ptr(), D.data_ptr(),
                    dt_bias.data_ptr(),
                    out.data_ptr(), h_last.data_ptr(),
                    0 if states is None else states.data_ptr(), B, S, d_in,
                    st, bc_stride, z.stride(1),
                    int(xc.dtype == torch.bfloat16),
                    _build.stream_handle(dt.device))
    return h_last, out, states


def selective_scan_fused_backward(
        h0: Optional[torch.Tensor], dt: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor,
        D: torch.Tensor, z: torch.Tensor, dt_bias: torch.Tensor,
        dout: torch.Tensor, dh_last: Optional[torch.Tensor] = None,
        states: Optional[torch.Tensor] = None
        ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of :func:`selective_scan_fused` given ``dout`` (B, S,
    d_in) in the model's dtype and ``dh_last`` (B, d_in, st) or None
    (zero): ``(dh0, ddt, dBm, dCm, dA, dxc, dD, dz, ddt_bias)`` as
    :func:`repro_torch.kernels.ref.selective_scan_fused_backward` returns
    them.  On the card one launch of the backward kernel, which reads the
    forward's ``states`` (:func:`selective_scan_fused_forward` with
    ``save_states``; required there) and walks each block's tiles from
    the last to the first.  Its sums over channels (dBm, dCm) come out
    as one partial row of (B, S, 2 st) fp32 a thread-block cluster of
    ``CHANNELS_PER_PARTIAL`` channels (the blocks of a cluster add theirs
    up in shared memory), those over the batch (dA, dD, ddt_bias) as one
    row a sequence; ``sum(0)`` adds the partials up (no float atomics on
    either side, so two launches give the same bits)."""
    B, S, d_in = dt.shape
    st = A.shape[-1] if A.dim() == 2 else -1
    more = {"dout": (dout, dt.shape)}
    if dh_last is not None:
        more["dh_last"] = (dh_last, (B, d_in, st))
    _check_fused(h0, dt, Bm, Cm, A, xc, D, z, dt_bias, **more)
    if dout.dtype != xc.dtype:
        raise ValueError(f"dout is {dout.dtype}, xc {xc.dtype}")
    if dt.device.type == "cpu":
        return ref.selective_scan_fused_backward(h0, dt, Bm, Cm, A, xc, D, z,
                                                 dt_bias, dout, dh_last)
    _card_checks(dt, A, xc, Bm, Cm)
    want = (B, -(-S // TILE), d_in, st)
    if states is None or tuple(states.shape) != want \
            or states.dtype != torch.float32 or states.device != dt.device:
        raise ValueError(f"states must be {want} float32 on {dt.device} "
                         f"(the forward's save_states), got "
                         f"{None if states is None else tuple(states.shape)}")
    dt, xc, dout, states = (_aligned(t) for t in (dt, xc, dout, states))
    A, D = (_aligned(t.float()) for t in (A, D))
    dh_last = None if dh_last is None else _aligned(dh_last.float())
    dt_bias = _aligned(dt_bias)
    if not _rows_in_place(z):
        z = _aligned(z)
    bc, bc_stride = _bc_rows(Bm, Cm)
    n_part = -(-d_in // CHANNELS_PER_PARTIAL)
    f32 = dict(dtype=torch.float32, device=dt.device)
    with _build.on_device(dt.device):
        ddt, dx, dz = (torch.empty((B, S, d_in), dtype=xc.dtype,
                                   device=dt.device) for _ in range(3))
        dbc_part = torch.empty((n_part, B, S, 2 * st), **f32)
        # dA (d_in, st), dD (d_in,) and ddt_bias (d_in,) side by side
        red_part = torch.empty((B, d_in * (st + 2)), **f32)
        dh0 = None if h0 is None else torch.empty((B, d_in, st), **f32)
        _LIB.launch("selective_scan_fused_backward", dt.data_ptr(),
                    xc.data_ptr(), z.data_ptr(), bc.data_ptr(), A.data_ptr(),
                    D.data_ptr(), dt_bias.data_ptr(), dout.data_ptr(),
                    0 if dh_last is None else dh_last.data_ptr(),
                    states.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
                    dz.data_ptr(), dbc_part.data_ptr(), red_part.data_ptr(),
                    0 if dh0 is None else dh0.data_ptr(), B, S, d_in, st,
                    bc_stride, z.stride(1), int(xc.dtype == torch.bfloat16),
                    _build.stream_handle(dt.device))
        dbc, red = dbc_part.sum(0), red_part.sum(0)
    n = d_in * st
    return (dh0, ddt, dbc[..., :st].to(Bm.dtype), dbc[..., st:].to(Cm.dtype),
            red[:n].view(d_in, st), dx, red[n:n + d_in],
            dz, red[n + d_in:].to(dt_bias.dtype))


class SelectiveScanFusedFn(torch.autograd.Function):
    """The fused scan with a gradient: ``SelectiveScanFusedFn.apply(h0,
    dt, Bm, Cm, A, xc, D, z, dt_bias, chunk) -> (h_last, out)``.  Forward
    saves the inputs and, on the card, each tile's starting state;
    backward is :func:`selective_scan_fused_backward`, given ``dout`` and
    the gradient of ``h_last`` (None when nothing reads h_last, as in
    training).  Kernels on CUDA tensors, the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, h0, dt, Bm, Cm, A, xc, D, z, dt_bias, chunk: int):
        h_last, out, states = selective_scan_fused_forward(
            h0, dt, Bm, Cm, A, xc, D, z, dt_bias, chunk,
            save_states=dt.device.type != "cpu")
        ctx.save_for_backward(h0, dt, Bm, Cm, A, xc, D, z, dt_bias, states)
        ctx.set_materialize_grads(False)
        return h_last, out

    @staticmethod
    def backward(ctx, dh_last, dout):
        h0, dt, Bm, Cm, A, xc, D, z, dt_bias, states = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(dt.shape, dtype=xc.dtype, device=dt.device)
        grads = selective_scan_fused_backward(
            h0, dt, Bm, Cm, A, xc, D, z, dt_bias, dout, dh_last, states)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)
