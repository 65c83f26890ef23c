"""Mamba's selective scan, forward: the wrapper around
``csrc/selective_scan.cu``.

The JAX package has no Pallas kernel here: it runs the scan in jnp, a
log-depth associative scan over 256-step chunks under ``lax.scan``
(``repro.models.blocks._selective_scan_chunk``).  At falcon-mamba-7b's
width that form, or a plain loop of PyTorch ops over 2,048 steps, costs
seconds a prefill; one launch of this kernel runs a layer's whole
sequence with the state in registers.  The contract is
:func:`repro_torch.kernels.ref.selective_scan` (fp32, step by step).

:func:`selective_scan` takes the reference's arguments ``(h0, dt, Bm, Cm,
A, xc)`` and returns ``(h_last, y)``, both fp32.  On CPU tensors the plain
version runs (differentiable).  On CUDA tensors the kernel runs or the
call raises: there is no switch and no fallback, and with a gradient
requested it raises ``NotImplementedError``, since no backward kernel
exists yet (ROADMAP Queue 1 item 5(c), Mamba training on the card).
``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

#: the state sizes the kernel is built for: the reference's test config
#: (4), reduced falcon-mamba (8), falcon-mamba-7b (16)
D_STATES = (4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)

_LIB = _build.Library("selective_scan", {
    # dt, x, bm, cm, A, h0, y, h_last, B, S, d_in, st, bc_stride, is_bf16,
    # stream
    "selective_scan_forward": 15,
})
#: kernel launches since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset


def _check(h0: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, A: torch.Tensor, xc: torch.Tensor) -> None:
    if dt.dim() != 3:
        raise ValueError(f"dt must be (B, S, d_in), got {tuple(dt.shape)}")
    B, S, d_in = dt.shape
    st = A.shape[-1] if A.dim() == 2 else -1
    want = {"xc": (xc, (B, S, d_in)), "Bm": (Bm, (B, S, st)),
            "Cm": (Cm, (B, S, st)), "A": (A, (d_in, st)),
            "h0": (h0, (B, d_in, st))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for dt "
                             f"{tuple(dt.shape)}, got {tuple(t.shape)}")
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h0, dt, Bm, Cm, A, xc)):
        raise NotImplementedError(
            "selective_scan: no backward kernel on the card yet (ROADMAP "
            "Queue 1 item 5(c), Mamba training on the card); the plain "
            "version's gradient runs on CPU tensors")
    B, S, d_in = dt.shape
    st = A.shape[1]
    if st not in D_STATES:
        raise ValueError(f"d_state {st} not in {D_STATES}")
    if xc.dtype not in DTYPES or Bm.dtype != xc.dtype \
            or Cm.dtype != xc.dtype:
        raise ValueError(f"xc, Bm and Cm must share one dtype of {DTYPES}, "
                         f"got {xc.dtype}, {Bm.dtype}, {Cm.dtype}")
    if B > 65535:
        raise ValueError(f"batch {B} past the grid's y limit of 65535")
    dt, A, h0 = (t.float().contiguous() for t in (dt, A, h0))
    xc = xc.contiguous()
    # Bm and Cm in place where each (b, t) row sits a fixed stride apart
    # with its states contiguous; a copy otherwise
    bc = []
    for t in (Bm, Cm):
        if t.stride(2) != 1 or t.stride(0) != S * t.stride(1):
            t = t.contiguous()
        bc.append(t)
    Bm, Cm = bc
    if Bm.stride(1) != Cm.stride(1):
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    with _build.on_device(dt.device):
        y = torch.empty((B, S, d_in), dtype=torch.float32, device=dt.device)
        h_last = torch.empty((B, d_in, st), dtype=torch.float32,
                             device=dt.device)
        _LIB.launch("selective_scan_forward", dt.data_ptr(), xc.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S,
                    d_in, st, Bm.stride(1), int(xc.dtype == torch.bfloat16),
                    _build.stream_handle(dt.device))
    return h_last, y
