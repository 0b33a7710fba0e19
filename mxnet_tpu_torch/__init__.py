"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

A package of its own beside the JAX package, with the same module names
and layout so each counterpart is easy to find.  It imports ``torch``
and numpy, never ``jax`` and nothing of ``mxnet_tpu``.  Plain tensor
code is PyTorch; each TPU (Pallas) kernel on a ported path is a kernel
written by hand for ``sm_90a`` (``ops/cuda``).

Entry points run on the card by default (``device="cuda"``, or
``ctx=None`` in the Gluon API) and raise when there is none, unless the
caller asks for ``"cpu"``, which runs every kernel's plain PyTorch
version.

Ported so far:

- LLM serving — ``serving.GenerationServer`` over the causal LM
  (``gluon.model_zoo.causal_lm``) with the ragged paged decode attention
  kernel (``ops.paged_decode_attention``);
- ResNet v1 training — ``gluon.model_zoo.vision.resnet50_v1`` (and the
  other v1 depths) through ``parallel.TrainStep`` with SGD, with the
  fused norm -> relu -> conv forward, dX and dW kernels
  (``ops.norm_relu_conv``) when built with ``fused=True``.
"""
from . import autograd, context, gluon, initializer, optimizer, parallel
from .context import cpu, current_context, gpu, resolve_device

__all__ = ["autograd", "context", "gluon", "initializer", "optimizer",
           "parallel", "cpu", "gpu", "current_context", "resolve_device"]
