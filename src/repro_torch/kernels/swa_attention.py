"""Sliding-window GQA flash attention: the wrapper around
``csrc/swa_attention.cu``, forward and backward.

The port of ``repro.kernels.swa_attention.swa_attention_pallas``, in its
folded layout: ``q (B*Hq, Sq, d)``, ``k``/``v (B*Hkv, Skv, d)``, kv row =
q row // (B*Hq / B*Hkv).  Key ``j`` is visible to query ``i`` iff
``q_offset + i - window < j <= q_offset + i``; scores are scaled by
``d ** -0.5``, the softmax runs in fp32, and the output has q's dtype.
The contract is :func:`repro_torch.kernels.ref.swa_attention_ref` on the
same tensors with a batch axis of 1; the backward's is
:func:`repro_torch.kernels.ref.swa_attention_backward_ref` (the reference
differentiates its jnp scan instead: there is no Pallas backward).

:func:`swa_attention_forward` is the no-grad entry that prefill uses;
:class:`SWAAttentionFn` is the differentiable one that training uses: its
forward also writes each query's log-sum-exp, and its backward launches
``swa_attention_bwd_dot`` (D = rowsum(dO * O)),
``swa_attention_backward_dkdv`` and ``swa_attention_backward_dq``.

On CPU tensors the plain PyTorch versions run.  On CUDA tensors the
kernels run or the call raises: there is no switch and no fallback.  Both
take fp32 or bf16 and any head dim the reference takes; the kernels also
need contiguous tensors and ``d`` in :data:`HEAD_DIMS`
(:func:`_check_kernel`).  At d = 256 the tiles that fit shared memory
differ (a 2-stage ring in bf16, one K/V buffer in the fp32 forward,
32-query tiles in the fp32 backward: :func:`f32_backward_rows`, and two
warpgroups splitting d's columns in the bf16 backward:
:func:`dkdv_keys`); the plans below describe them.  Ragged Sq and Skv
are masked in the kernels, not padded.  bf16 runs on wgmma with TMA-fed tiles (forward and backward),
fp32 on the CUDA cores; the forward and dQ kernels walk the tiles
:func:`swa_tile_plan` gives, the dK/dV kernels those of
:func:`swa_key_tile_plan`, and all mask only the tiles the plan does not
call interior.  ``launches`` counts kernel launches by entry point.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import _build, ref

#: head dims the kernel is built for (reference tests 16/32/64, reduced
#: h2o-danube 64, h2o-danube 80, recurrentgemma-2b 256)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
#: 64-query tiles per head on the grid's y axis (at most 65535 of them)
MAX_SEQ = 65535 * 64
#: query rows of one tile-plan block (a bf16 warpgroup, an fp32 block)
#: and keys of one K/V tile (BK in swa_attention.cu)
PLAN_ROWS, KEY_TILE = 64, 64
_INT_MAX = 2**31 - 1

_LIB = _build.Library("swa_attention", {
    # q, k, v, o, lse, bhq, bhkv, sq, skv, hd, window, q_offset, is_bf16,
    # stream
    "swa_attention_forward": 14,
    # o, do, dvec, rows, hd, is_bf16, stream
    "swa_attention_bwd_dot": 7,
    # q, k, v, do, lse, dvec, dk, dv, bhq, bhkv, sq, skv, hd, window,
    # q_offset, is_bf16, stream
    "swa_attention_backward_dkdv": 17,
    # q, k, v, do, lse, dvec, dq, bhq, bhkv, sq, skv, hd, window, q_offset,
    # is_bf16, stream
    "swa_attention_backward_dq": 16,
})
#: kernel launches since the last reset_launches()
launches = _LIB.launches
reset_launches = _LIB.reset


def _interior(k0: int, first: int, last: int, q_offset: int, window: int,
              skv: int, bk: int) -> bool:
    """``tile_interior`` in swa_attention.cu: every pair of the real query
    rows ``[first, last]`` and the keys ``[k0, k0 + bk)`` is visible, and
    the tile ends inside ``skv``."""
    return (k0 + bk - 1 <= q_offset + first
            and k0 >= q_offset + last - window + 1 and k0 + bk <= skv)


def swa_tile_plan(sq: int, skv: int, window: int, q_offset: int,
                  bq: int = PLAN_ROWS, bk: int = KEY_TILE
                  ) -> List[Tuple[int, List[Tuple[int, bool]]]]:
    """The key tiles each block of ``bq`` query rows visits, as the
    forward and dQ kernels walk them (``band_lo``, ``band_hi`` and
    ``tile_interior`` in swa_attention.cu): ``[(q0, [(k0, interior),
    ...]), ...]``.

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
        tiles = [(k0, _interior(k0, q0, last, q_offset, window, skv, bk))
                 for k0 in range(lo - lo % bk, hi + 1, bk)] if lo <= hi else []
        plan.append((q0, tiles))
    return plan


def dkdv_keys(d: int) -> int:
    """Keys of one CTA of the bf16 dK/dV kernel (``Dkdv`` in
    swa_attention.cu): 64 a consumer warpgroup, two of them at d <= 80,
    one at d = 128; at d = 256 two warpgroups share 64 keys, each with
    half of d's columns of dK and dV."""
    return 2 * KEY_TILE if d <= 80 else KEY_TILE


def f32_backward_rows(d: int) -> int:
    """Query rows of a tile of the fp32 backward kernels (``f32_bwd_rows``
    in swa_attention.cu): the ``bq`` of the plans they walk, 64 up to
    d = 128 and 32 at d = 256.  The bf16 kernels and every forward walk
    64-row plans at every head dim."""
    return 32 if d > 128 else PLAN_ROWS


def swa_key_tile_plan(sq: int, skv: int, window: int, q_offset: int,
                      keys: int = 2 * KEY_TILE, bk: int = KEY_TILE,
                      bq: int = PLAN_ROWS
                      ) -> List[Tuple[int, List[Tuple[int, bool]]]]:
    """The query tiles each ``bk``-key tile visits in the dK/dV kernels,
    the transpose of :func:`swa_tile_plan`: ``[(k0, [(q0, interior),
    ...]), ...]``, over the key tiles that hold a key below ``skv``.

    A CTA holds the ``keys`` keys from ``c0`` and streams the ``bq``-query
    tiles that meet the queries its real keys are seen by, ``[c0 -
    q_offset, c_last - q_offset + window - 1]`` cut to ``[0, sq)``; each of
    its ``bk``-key tiles (a warpgroup's) visits those that meet its own
    such range and masks the ones ``tile_interior`` does not call
    interior.  A tile wholly past ``skv`` belongs to no warpgroup."""
    plan = []
    for c0 in range(0, skv, keys):
        c_last = min(c0 + keys, skv) - 1
        lo, hi = max(0, c0 - q_offset), min(sq - 1,
                                            c_last - q_offset + window - 1)
        cta = range(lo - lo % bq, hi + 1, bq) if lo <= hi else range(0)
        for k0 in range(c0, c_last + 1, bk):
            k_last = min(k0 + bk, skv) - 1
            wlo = max(0, k0 - q_offset)
            whi = min(sq - 1, k_last - q_offset + window - 1)
            plan.append((k0, [
                (q0, _interior(k0, q0, min(q0 + bq, sq) - 1, q_offset,
                               window, skv, bk))
                for q0 in cta if wlo <= whi and q0 <= whi
                and q0 + bq - 1 >= wlo]))
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


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  **more: torch.Tensor) -> None:
    """The kernel's own limits, past :func:`_check`: a head dim it is built
    for and contiguous, 16-byte aligned tensors (q, k, v and the
    backward's ``more``).  The plain version takes any head dim and any
    strides."""
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned for the kernel")


def swa_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int, q_offset: int = 0, *,
                          return_lse: bool = False):
    """``(B*Hq, Sq, d)`` attention output in q's dtype; with ``return_lse``
    also each query's log-sum-exp ``(B*Hq, Sq)`` fp32 (-inf for a query
    that sees no key), as ``(o, lse)``."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        o = ref.swa_attention_ref(q[None], k[None], v[None], window,
                                  q_offset)[0]
        if not return_lse:
            return o
        return o, ref.swa_attention_lse_ref(q[None], k[None], window,
                                            q_offset)[0]
    _check_kernel(q, k, v)
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    with _build.on_device(q.device):
        o = torch.empty_like(q)
        lse = (torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
               if return_lse else None)
        _LIB.launch("swa_attention_forward", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(),
                    0 if lse is None else lse.data_ptr(), bhq, bhkv, sq, skv,
                    d, min(window, _INT_MAX), q_offset,
                    int(q.dtype == torch.bfloat16),
                    _build.stream_handle(q.device))
    return (o, lse) if return_lse else o


def swa_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, window: int, q_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``(dq, dk, dv)`` of the folded attention, in q's dtype, from the
    forward's inputs, its output ``o``, its log-sum-exp ``lse`` and the
    output's gradient ``do``.  On the card: three launches
    (``bwd_dot``, ``backward_dkdv``, ``backward_dq``), each gradient
    written once, no atomics."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or o.dtype != q.dtype or do.dtype != q.dtype \
            or tuple(lse.shape) != (bhq, sq) or lse.dtype != torch.float32 \
            or any(x.device != q.device for x in (o, lse, do)):
        raise ValueError(f"o and do must be {tuple(q.shape)} {q.dtype} and "
                         f"lse ({bhq}, {sq}) float32, got {tuple(o.shape)} "
                         f"{o.dtype}, {tuple(do.shape)} {do.dtype}, "
                         f"{tuple(lse.shape)} {lse.dtype}, all on "
                         f"{q.device}")
    if q.device.type == "cpu":
        dq, dk, dv = ref.swa_attention_backward_ref(
            q[None], k[None], v[None], o[None], lse[None], do[None], window,
            q_offset)
        return dq[0], dk[0], dv[0]
    _check_kernel(q, k, v, o=o, do=do, lse=lse)
    bf16 = int(q.dtype == torch.bfloat16)
    stream = _build.stream_handle(q.device)
    w = min(window, _INT_MAX)
    with _build.on_device(q.device):
        dvec = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        _LIB.launch("swa_attention_bwd_dot", o.data_ptr(), do.data_ptr(),
                    dvec.data_ptr(), bhq * sq, d, bf16, stream)
        _LIB.launch("swa_attention_backward_dkdv", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), bhq, bhkv, sq, skv, d, w, q_offset, bf16,
                    stream)
        _LIB.launch("swa_attention_backward_dq", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    dvec.data_ptr(), dq.data_ptr(), bhq, bhkv, sq, skv, d, w,
                    q_offset, bf16, stream)
    return dq, dk, dv


class SWAAttentionFn(torch.autograd.Function):
    """The folded attention with a gradient: ``SWAAttentionFn.apply(q, k,
    v, window, q_offset)``.  Forward saves ``q, k, v, o, lse``; backward
    is :func:`swa_attention_backward`.  Kernels on CUDA tensors, the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, q_offset: int):
        o, lse = swa_attention_forward(q, k, v, window, q_offset,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.q_offset = int(window), int(q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = swa_attention_backward(q, k, v, o, lse, do.contiguous(),
                                            ctx.window, ctx.q_offset)
        return dq, dk, dv, None, None
