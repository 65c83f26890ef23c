"""Bio-KGvec2go on PyTorch and CUDA: the serving path, the update path and
dense-LM generation of ``repro``, ported to one NVIDIA Hopper card.

The package mirrors the JAX package's module names (``checkpoint``,
``kernels``, ``core``, ``api``, ``kge``, ``models``, ``launch``) so each
counterpart is easy to find, reads and writes the same ``biokg-raw-v1``
snapshot store, and answers the same gateway routes with the same wire
bodies.  It imports nothing of ``repro`` and never JAX.  Top-k, KGE scoring
and sliding-window attention run in hand-written CUDA kernels on the card
(``kernels/csrc/*.cu``) and in their plain PyTorch versions on the CPU
(``kernels/ref.py``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
