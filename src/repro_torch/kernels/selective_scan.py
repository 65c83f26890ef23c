"""Mamba's selective scan, forward: the wrappers around
``csrc/selective_scan.cu``.

The JAX package has no Pallas kernel here: it runs the scan in jnp, a
log-depth associative scan over 256-step chunks under ``lax.scan``
(``repro.models.blocks._selective_scan_chunk``), and the layer's tail
around it (softplus of dt, the D skip, the silu(z) gate) as jnp passes.
At falcon-mamba-7b's width that form, or a plain loop of PyTorch ops over
2,048 steps, costs seconds a prefill; one launch of the kernel runs a
layer's whole sequence with the state in registers.

Two entry points share one kernel body:

- :func:`selective_scan_fused`, the main path (``models.blocks``): dt
  before ``dt_proj``'s bias and softplus, xc, z, Bm and Cm in
  the model's dtype, returns ``(h_last fp32, out)`` with out in the model
  dtype, ``(y + D xc) * silu(z)``.  Its contract is
  :func:`repro_torch.kernels.ref.selective_scan_fused`.
- :func:`selective_scan`, the bare scan: dt softplus'd in fp32, returns
  ``(h_last, y)`` in fp32.  Its contract is
  :func:`repro_torch.kernels.ref.selective_scan` (fp32, step by step).

On CPU tensors the plain versions run (differentiable).  On CUDA tensors
the kernel runs or the call raises: there is no switch and no fallback,
and with a gradient requested it raises ``NotImplementedError``, since no
backward kernel exists yet (ROADMAP Queue 1 item 5(c'), Mamba training on
the card).  ``launches`` counts kernel launches by entry point.
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

_LIB = _build.Library("selective_scan", {
    # dt, x, bc, A, h0, y, h_last, B, S, d_in, st, bc_stride, is_bf16,
    # stream
    "selective_scan_forward": 14,
    # dt, x, z, bc, A, h0, D, dt_bias, out, h_last, B, S, d_in, st,
    # bc_stride, z_stride, is_bf16, stream
    "selective_scan_fused": 18,
})
#: kernel launches by entry point since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset

_NO_GRAD_MSG = ("no backward kernel on the card yet (ROADMAP Queue 1 item "
                "5(c'), Mamba training on the card); the plain version's "
                "gradient runs on CPU tensors")


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


def _card_checks(name: str, tensors, dt: torch.Tensor, A: torch.Tensor,
                 xc: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: {_NO_GRAD_MSG}")
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
    _card_checks("selective_scan", (h0, dt, Bm, Cm, A, xc), dt, A, xc, Bm,
                 Cm)
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
    steps at a time, as the reference does."""
    _check(h0, dt, Bm, Cm, A, xc, z=(z, dt.shape), D=(D, dt.shape[2:]),
           dt_bias=(dt_bias, dt.shape[2:]))
    for name, t in (("dt", dt), ("z", z), ("dt_bias", dt_bias)):
        if t.dtype != xc.dtype:
            raise ValueError(f"{name} is {t.dtype}, xc {xc.dtype}: the "
                             f"fused scan takes one model dtype")
    if dt.device.type == "cpu":
        return ref.selective_scan_fused(h0, dt, Bm, Cm, A, xc, D, z,
                                        dt_bias, chunk)
    _card_checks("selective_scan_fused", (h0, dt, Bm, Cm, A, xc, D, z,
                                          dt_bias), dt, A, xc, Bm, Cm)
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
        _LIB.launch("selective_scan_fused", dt.data_ptr(), xc.data_ptr(),
                    z.data_ptr(), bc.data_ptr(), A.data_ptr(),
                    0 if h0 is None else h0.data_ptr(), D.data_ptr(),
                    dt_bias.data_ptr(),
                    out.data_ptr(), h_last.data_ptr(), B, S, d_in, st,
                    bc_stride, z.stride(1), int(xc.dtype == torch.bfloat16),
                    _build.stream_handle(dt.device))
    return h_last, out
