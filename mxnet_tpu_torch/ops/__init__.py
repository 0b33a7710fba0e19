"""Ops of the port: plain PyTorch functions on tensors, and the wrappers
of the hand-written CUDA kernels (``ops/cuda``).  This module is also
the op namespace ``F`` that ``HybridBlock.hybrid_forward`` receives."""
from .attention import multi_head_attention
from .fused_conv import norm_relu_conv, norm_relu_conv_reference
from .loss import softmax_cross_entropy
from .matrix import pick
from .nn import (Activation, BatchNorm, Convolution, FullyConnected,
                 FusedNormReluConv, Pooling, log_softmax, moments)
from .paged_attention import (dense_decode_attention, paged_decode_attention,
                              paged_decode_attention_reference)

__all__ = ["multi_head_attention", "paged_decode_attention",
           "paged_decode_attention_reference", "dense_decode_attention",
           "norm_relu_conv", "norm_relu_conv_reference",
           "softmax_cross_entropy", "pick", "Activation", "BatchNorm",
           "Convolution", "FullyConnected", "FusedNormReluConv", "Pooling",
           "log_softmax", "moments"]
