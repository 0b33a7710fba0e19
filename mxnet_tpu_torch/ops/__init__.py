"""Ops of the port: plain PyTorch functions on tensors, registered by
name in ``registry.OPS`` as the JAX package registers its ops, and the
wrappers of the hand-written CUDA kernels (``ops/cuda``).  This module
is also the op namespace ``F`` that ``HybridBlock.hybrid_forward``
receives: every registered name is an attribute here.

As in the JAX package's op registry, ``F.flash_attention`` is the op on
``(B, S, H*D)`` projections (``ops/attention.py``); the kernels' own
``(B*H, S, D)`` function and their launch counts are in the module
``mxnet_tpu_torch.ops.flash_attention`` (import names from it with
``from mxnet_tpu_torch.ops.flash_attention import ...``)."""
import sys as _sys

from . import registry
from .registry import OPS, OP_META, alias_op, get_op, register_op

# the op families, imported for their registrations
from . import elementwise, image, loss, matrix, nn, optimizer_ops  # noqa: F401
from . import multibox, rnn, sequence  # noqa: F401
from . import control_flow, quantization, random_ops  # noqa: F401
from . import reduce as reduce_ops  # noqa: F401
from .attention import flash_attention, multi_head_attention
from .fused_conv import norm_relu_conv, norm_relu_conv_reference
from .loss import softmax_cross_entropy
from .matrix import Embedding, gather_nd, pick
from .nn import (Activation, BatchNorm, Convolution, Deconvolution, Dropout,
                 FullyConnected, FusedNormReluConv, LayerNorm, Pooling,
                 log_softmax, moments, softmax)
from .paged_attention import (dense_decode_attention, paged_decode_attention,
                              paged_decode_attention_reference)

_this = _sys.modules[__name__]
for _name, _fn in OPS.items():
    if not hasattr(_this, _name):
        setattr(_this, _name, _fn)

__all__ = ["OPS", "OP_META", "register_op", "alias_op", "get_op",
           "registry", "multi_head_attention", "flash_attention",
           "paged_decode_attention", "paged_decode_attention_reference",
           "dense_decode_attention", "norm_relu_conv",
           "norm_relu_conv_reference", "softmax_cross_entropy", "pick",
           "Embedding", "gather_nd", "Activation", "BatchNorm",
           "Convolution", "Deconvolution", "Dropout", "FullyConnected",
           "FusedNormReluConv", "LayerNorm", "Pooling", "log_softmax",
           "softmax", "moments"]
