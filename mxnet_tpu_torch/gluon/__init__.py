"""Gluon API of the port: blocks, parameters, layers, losses and the
model zoo."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "loss", "model_zoo", "nn"]
