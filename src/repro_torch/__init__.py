"""Bio-KGvec2go on PyTorch and CUDA: the serving path of ``repro``,
ported to one NVIDIA Hopper card.

The package mirrors the JAX package's module names (``checkpoint``,
``kernels``, ``core``, ``api``, ``launch``) so each counterpart is easy to
find, reads and writes the same ``biokg-raw-v1`` snapshot store, and
answers the same gateway routes with the same wire bodies.  It imports
nothing of ``repro`` and never JAX.  Top-k runs in a hand-written CUDA
kernel on the card (``kernels/csrc/topk_cosine.cu``) and in its plain
PyTorch version on the CPU (``kernels/ref.py``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
