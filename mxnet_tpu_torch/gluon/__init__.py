"""Gluon API of the port: blocks, parameters, layers, losses, the
trainer, utilities, the recurrent layers and cells (``rnn``), the model
zoo, ``contrib`` (``HybridConcurrent``, the Estimator) and ``data``
(datasets, samplers, the DataLoader, vision datasets and transforms)."""
from . import data, loss, model_zoo, nn, rnn, utils
from . import contrib
from .block import Block, HybridBlock, SymbolBlock, params_from_jax
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "params_from_jax",
           "contrib", "data", "loss", "model_zoo", "nn", "rnn", "utils"]
