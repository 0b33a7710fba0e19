"""gluon.nn of the port: the layers of ``mxnet_tpu.gluon.nn``."""
from ..block import Block, HybridBlock, SymbolBlock
from .activations import *
from .basic_layers import *
from .conv_layers import *
from .fused import *

from . import activations, basic_layers, conv_layers, fused

__all__ = (["Block", "HybridBlock", "SymbolBlock"] + activations.__all__
           + basic_layers.__all__ + conv_layers.__all__ + fused.__all__)
