"""Ops of the port: plain PyTorch functions on tensors, and the wrappers
of the hand-written CUDA kernels (``ops/cuda``).  This module is also
the op namespace ``F`` that ``HybridBlock.hybrid_forward`` receives.

As in the JAX package's op registry, ``F.flash_attention`` is the op on
``(B, S, H*D)`` projections (``ops/attention.py``); the kernels' own
``(B*H, S, D)`` function and their launch counts are in the module
``mxnet_tpu_torch.ops.flash_attention`` (import names from it with
``from mxnet_tpu_torch.ops.flash_attention import ...``)."""
from .attention import flash_attention, multi_head_attention
from .fused_conv import norm_relu_conv, norm_relu_conv_reference
from .loss import softmax_cross_entropy
from .matrix import Embedding, gather_nd, pick
from .nn import (Activation, BatchNorm, Convolution, Dropout, FullyConnected,
                 FusedNormReluConv, LayerNorm, Pooling, log_softmax, moments)
from .paged_attention import (dense_decode_attention, paged_decode_attention,
                              paged_decode_attention_reference)

__all__ = ["multi_head_attention", "flash_attention",
           "paged_decode_attention", "paged_decode_attention_reference",
           "dense_decode_attention", "norm_relu_conv",
           "norm_relu_conv_reference", "softmax_cross_entropy", "pick",
           "Embedding", "gather_nd", "Activation", "BatchNorm",
           "Convolution", "Dropout", "FullyConnected", "FusedNormReluConv",
           "LayerNorm", "Pooling", "log_softmax", "moments"]
