"""Ops of the port: plain PyTorch functions on tensors, and the wrappers
of the hand-written CUDA kernels (``ops/cuda``)."""
from .attention import multi_head_attention
from .paged_attention import (dense_decode_attention, paged_decode_attention,
                              paged_decode_attention_reference)

__all__ = ["multi_head_attention", "paged_decode_attention",
           "paged_decode_attention_reference", "dense_decode_attention"]
