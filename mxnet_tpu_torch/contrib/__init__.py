"""mx.contrib (the port of ``mxnet_tpu/contrib/``; ref:
python/mxnet/contrib/)."""
from . import quantization
