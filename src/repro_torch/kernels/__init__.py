"""Kernels of the port: the CUDA kernels for Hopper (``csrc/topk_cosine.cu``,
``csrc/kge_score.cu``, ``csrc/swa_attention.cu``,
``csrc/selective_scan.cu``), their wrappers, their plain PyTorch versions
and the top-k streaming driver."""
from . import (kge_score, ops, ref, selective_scan, swa_attention,
               topk_similarity)

__all__ = ["kge_score", "ops", "ref", "selective_scan", "swa_attention",
           "topk_similarity"]
