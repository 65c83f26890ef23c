"""Sliding-window GQA flash attention: the wrapper around
``csrc/swa_attention.cu``.

The port of ``repro.kernels.swa_attention.swa_attention_pallas``, in its
folded layout: ``q (B*Hq, Sq, d)``, ``k``/``v (B*Hkv, Skv, d)``, kv row =
q row // (B*Hq / B*Hkv).  Key ``j`` is visible to query ``i`` iff
``q_offset + i - window < j <= q_offset + i``; scores are scaled by
``d ** -0.5``, the softmax runs in fp32, and the output has q's dtype.
The contract is :func:`repro_torch.kernels.ref.swa_attention_ref` on the
same tensors with a batch axis of 1.

On CPU tensors the plain PyTorch version runs.  On CUDA tensors the
kernel runs or the call raises: there is no switch and no fallback.  Both
take fp32 or bf16 and any head dim the reference takes; the kernel also
needs contiguous tensors and ``d`` in :data:`HEAD_DIMS`
(:func:`_check_kernel`).  Ragged Sq and Skv are masked in the kernel, not
padded.  bf16 runs on wgmma with TMA-fed K/V tiles, fp32 on the CUDA
cores; both walk the tiles :func:`swa_tile_plan` gives and mask only the
tiles it does not call interior.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import _build, ref

#: head dims the kernel is built for (reference tests 16/32/64, reduced
#: h2o-danube 64, h2o-danube 80)
HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: 64-query tiles per head on the grid's y axis (at most 65535 of them)
MAX_SEQ = 65535 * 64
#: query rows of one tile-plan block (a bf16 warpgroup, an fp32 block)
#: and keys of one K/V tile (BK in swa_attention.cu)
PLAN_ROWS, KEY_TILE = 64, 64
_INT_MAX = 2**31 - 1

# q, k, v, o, bhq, bhkv, sq, skv, hd, window, q_offset, is_bf16, stream
_LIB = _build.Library("swa_attention", {"swa_attention_forward": 13})
#: kernel launches since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset


def swa_tile_plan(sq: int, skv: int, window: int, q_offset: int,
                  bq: int = PLAN_ROWS, bk: int = KEY_TILE
                  ) -> List[Tuple[int, List[Tuple[int, bool]]]]:
    """The key tiles each block of ``bq`` query rows visits, as the
    kernels walk them (``band_lo``, ``band_hi`` and ``tile_interior`` in
    swa_attention.cu): ``[(q0, [(k0, interior), ...]), ...]``.

    A block visits the ``bk``-key tiles that meet the keys its real rows
    (those below ``sq``) see together, ``[q_offset + q0 - window + 1,
    q_offset + last]`` cut to ``[0, skv)``.  A tile is interior when every
    (real row, key) pair in it is visible and it ends inside ``skv``; the
    kernels skip the mask there and compute it on every other tile."""
    plan = []
    for q0 in range(0, sq, bq):
        last = min(q0 + bq, sq) - 1
        lo = max(0, q_offset + q0 - window + 1)
        hi = min(skv - 1, q_offset + last)
        tiles = [(k0, k0 + bk - 1 <= q_offset + q0
                  and k0 >= q_offset + last - window + 1 and k0 + bk <= skv)
                 for k0 in range(lo - lo % bk, hi + 1, bk)] if lo <= hi else []
        plan.append((q0, tiles))
    return plan


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           q_offset: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (rows, S, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if bhkv < 1 or bhq % bhkv or tuple(k.shape) != (bhkv, skv, d) \
            or tuple(v.shape) != (bhkv, skv, d):
        raise ValueError(f"k and v must be (B*Hkv, Skv, {d}) with B*Hkv "
                         f"dividing B*Hq = {bhq}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if sq < 1 or skv < 1 or sq > MAX_SEQ or skv > MAX_SEQ:
        raise ValueError(f"need 1 <= Sq, Skv <= {MAX_SEQ}, got {sq}, {skv}")
    if window < 1 or q_offset < 0 or q_offset + sq > _INT_MAX:
        raise ValueError(f"need window >= 1 and 0 <= q_offset, got window "
                         f"{window}, q_offset {q_offset}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES or x.dtype != q.dtype \
                or x.device != q.device:
            raise ValueError(f"{name} must be a {q.dtype} tensor on "
                             f"{q.device} (fp32 or bf16), got {x.dtype} on "
                             f"{x.device}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernel's own limits, past :func:`_check`: a head dim it is built
    for and contiguous, 16-byte aligned tensors.  The plain version takes
    any head dim and any strides."""
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned for the kernel")


def swa_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int, q_offset: int = 0) -> torch.Tensor:
    """``(B*Hq, Sq, d)`` attention output in q's dtype."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return ref.swa_attention_ref(q[None], k[None], v[None], window,
                                     q_offset)[0]
    _check_kernel(q, k, v)
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    with _build.on_device(q.device):
        o = torch.empty_like(q)
        _LIB.launch("swa_attention_forward", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), bhq, bhkv, sq, skv, d,
                    min(window, _INT_MAX), q_offset,
                    int(q.dtype == torch.bfloat16),
                    _build.stream_handle(q.device))
    return o
