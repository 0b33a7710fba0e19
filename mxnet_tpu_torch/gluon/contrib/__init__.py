"""gluon.contrib (the port of ``mxnet_tpu/gluon/contrib/``; ref:
python/mxnet/gluon/contrib/) — experimental blocks and the Estimator."""
from . import nn
from . import estimator
