"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

A package of its own beside the JAX package, with the same module names
and layout so each counterpart is easy to find.  It imports ``torch``
and numpy, never ``jax`` and nothing of ``mxnet_tpu``.  Plain tensor
code is PyTorch; each TPU (Pallas) kernel on a ported path is a kernel
written by hand for ``sm_90a`` (``ops/cuda``).

Entry points take a ``device`` argument, ``"cuda"`` by default: they
run on the card and raise when there is none, unless the caller asks
for ``"cpu"``, which runs every kernel's plain PyTorch version.

Ported so far: LLM serving — ``serving.GenerationServer`` over the
causal LM (``gluon.model_zoo.causal_lm``) with the ragged paged decode
attention kernel (``ops.paged_decode_attention``).
"""
from . import context
from .context import resolve_device

__all__ = ["context", "resolve_device"]
