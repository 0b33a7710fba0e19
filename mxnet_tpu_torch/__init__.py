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
  (``ops.norm_relu_conv``) when built with ``fused=True``;
- BERT pretraining — ``gluon.model_zoo.bert.BERTModel`` with
  ``BERTPretrainLoss`` through ``parallel.TrainStep`` with LAMB, with the
  flash-attention forward, dQ and dK/dV kernels
  (``ops.flash_attention``) when built with ``attention_impl="flash"``;
- the imperative API — ``nd`` arrays (``ndarray.NDArray`` over a
  ``torch.Tensor``) and the registered ops (``ops.registry.OPS``,
  generated into ``nd``), ``autograd`` on NDArrays, the optimizers and
  ``gluon.Trainer``: the Gluon MLP loop of
  ``examples/train_mnist_mlp.py`` runs as written, with ``import
  mxnet_tpu_torch as mx``.  ``nd.FusedNormReluConv`` on card arrays
  reaches the fused-conv kernels.

The input pipeline: ``gluon.data`` (datasets, samplers, the
``DataLoader`` with host workers, the vision datasets and transforms),
``io`` (``NDArrayIter``, ``CSVIter``, ``MNISTIter``, ``ImageRecordIter``,
``PrefetchingIter``), ``recordio`` (files byte-identical to the JAX
package's), ``image`` and ``parallel.DevicePrefetcher`` (pinned staging
and a copy stream of its own); the host natives of ``src/`` (RecordIO,
the staging pool, the JPEG decoder) build with ``g++`` at first use
into ``mxnet_tpu_torch/_build/`` (``base.load_native_lib``).  ``config``
holds the ``MXNET_*`` knobs, ``storage`` the accounting of NDArray bytes
and the host staging pool.

The symbolic API: ``sym`` (``symbol``: Symbols over the op registry,
the JAX package's json byte for byte), ``executor`` (on the card its
programs are captured CUDA graphs, a training step a forward and
backward pair), ``mod`` (``module``: ``Module``, ``BucketingModule``),
``model`` (checkpoints), ``rnn`` (the legacy symbolic cells),
``callback``, ``mon`` (``monitor``), ``viz`` (``visualization``),
``name``, ``AttrScope`` (``attribute``) and ``gluon.SymbolBlock``.

On the card every step — ``parallel.TrainStep``, ``parallel.EvalStep``,
the server's prefill and decode steps and a hybridized Gluon block's
forward and backward (``HybridBlock.hybridize``) — runs as a captured
CUDA graph (``graphs``), the counterpart of the JAX package's compiled
programs; ``python -m mxnet_tpu_torch.bench {resnet,bert,llm}`` prints
``bench.py``'s line for each slice.

Classifier serving: ``serving.InferenceServer`` over a batched apply
function (``parallel.EvalStep``, a hybridized block, a bound ``Module``
through ``serving.module_apply``, in f32 or int8 with ``amp``'s
quantizer, or a ``graphs.captured`` function), ``serving.ServingFleet``
of replicas with ``WeightUpdater`` and ``FleetAutoscaler``.

Mixed precision and the rest of one card's training surface: ``amp``
(``init``, ``init_trainer``, ``scale_loss``, the loss scaler, and the
int8 weight quantizer of serving), the samplers and the int8 and
control-flow ops of the registry, ``operator`` (``CustomOp``,
``nd.Custom``), ``contrib.quantization`` (``quantize_net``),
``gluon.contrib`` (``HybridConcurrent``, the ``Estimator``),
``runtime``, ``test_utils``, ``util`` and ``log``.

The numpy frontend and the rest of one card's surface: ``np``
(``numpy``: ``mx.np.ndarray`` and numpy's functions on torch tensors,
``np.linalg``, ``np.random``), ``npx`` (``numpy_extension``:
``set_np()`` and the neural ops with numpy arrays), ``sparse``
(``nd.sparse``: row_sparse and csr arrays, their products, the lazy
optimizer updates behind ``Embedding(sparse_grad=True)``) and ``onnx``
(export through ``torch.export``'s core-aten graph, import as a
function on torch tensors).

Exports: ``nd`` (``ndarray``, with ``NDArray``), ``amp``, ``autograd``,
``config``, ``elastic``
(heartbeats and the gang supervisor; ``parallel.checkpoint`` the
snapshots they resume from), ``engine``,
``gluon``, ``image``, ``init`` (``initializer``), ``io``, ``metric``,
``optimizer``, ``parallel``, ``profiler``, ``random``, ``recordio``,
``serving``, ``storage``, the symbolic names above,
``Context``/``cpu``/``cpu_pinned``/``gpu``/``current_context``,
``num_gpus``, ``gpu_memory_info``, ``MXNetError`` and ``waitall``;
``distributed`` (the process group: one process per card), ``kvstore``
(``kv``) and ``parallel``'s mesh for data parallelism.  Under the
launcher's DMLC_* env with more than one worker, importing the package
joins the process group (``distributed.init()``), as the JAX package
connects its coordination service at import.
"""
import os as _os

__version__ = "0.1.0"       # the JAX package's; the C ABI reports it

from . import base, config, storage
from . import (amp, autograd, context, elastic, engine, gluon, image, initializer,
               io, lr_scheduler, metric, ndarray, optimizer, parallel,
               profiler, random, recordio)
from . import (attribute, callback, executor, model, module, monitor, name,
               rnn, serving, symbol, visualization)
from . import contrib, log, operator, runtime, test_utils, util
from . import numpy, numpy_extension, onnx, sparse
from . import distributed, kvstore
from .attribute import AttrScope
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      gpu_memory_info, num_gpus, resolve_device)
from .ndarray import NDArray

nd = ndarray
nd.sparse = sparse
np = numpy
npx = numpy_extension
init = initializer
sym = symbol
mod = module
mon = monitor
viz = visualization
waitall = engine.waitall
kv = kvstore

config._apply_startup()

if int(_os.environ.get("DMLC_NUM_WORKER", "0") or 0) > 1:
    distributed.init()

__all__ = ["amp", "autograd", "base", "config", "context", "elastic", "engine",
           "gluon",
           "image", "initializer", "init", "io", "lr_scheduler", "metric",
           "nd", "ndarray", "optimizer", "parallel", "profiler", "random",
           "recordio", "storage", "Context", "cpu", "cpu_pinned", "gpu",
           "current_context", "num_gpus", "gpu_memory_info",
           "resolve_device", "attribute", "AttrScope", "callback",
           "executor", "model", "module", "mod", "monitor", "mon", "name",
           "rnn", "serving", "symbol", "sym", "visualization", "viz",
           "MXNetError", "NDArray", "waitall", "contrib", "log", "operator",
           "runtime", "test_utils", "util", "np", "npx", "numpy",
           "numpy_extension", "onnx", "sparse", "distributed", "kvstore",
           "kv"]
