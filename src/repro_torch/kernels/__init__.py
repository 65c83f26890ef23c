"""Top-k kernels of the port: the CUDA kernel for Hopper
(``csrc/topk_cosine.cu``), its wrapper, its plain PyTorch version and the
streaming driver."""
from . import ops, ref, topk_similarity

__all__ = ["ops", "ref", "topk_similarity"]
