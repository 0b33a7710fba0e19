"""gluon.contrib.nn (the port of ``mxnet_tpu/gluon/contrib/nn``; ref:
python/mxnet/gluon/contrib/nn/basic_layers.py)."""
from .... import ops as F
from ...block import HybridBlock
from ...nn.basic_layers import SyncBatchNorm

__all__ = ["SyncBatchNorm", "Concurrent", "HybridConcurrent"]


class HybridConcurrent(HybridBlock):
    """Parallel branches of one input, concatenated on ``axis`` in the
    order they were added (ref: contrib/nn — HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def infer_shape(self, *args):
        pass

    def forward(self, x):
        return F.concat(*[b(x) for b in self._children.values()],
                        dim=self.axis)


class Concurrent(HybridConcurrent):
    """ref: contrib/nn — Concurrent."""
