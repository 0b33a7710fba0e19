"""KVStore — the reference's distributed parameter store (the port of
``mxnet_tpu/kvstore/``).

The push/pull/pushpull semantics are kept — per-key init (rank 0's value
in a distributed store), aggregation of pushed values, the optional
server-side optimizer update (``update_on_kvstore``), 2-bit gradient
compression — over ``torch.distributed``: there are no server
processes, every worker merges with an all-reduce (or, compressed, an
all-gather of the 2-bit wire format) through ``mxnet_tpu_torch.
distributed``.  The heavy-duty data-parallel path is
``parallel.TrainStep(mesh=...)``, which fuses what KVStore and the
optimizer do into the training step.
"""
from .kvstore import KVStore, create

__all__ = ["KVStore", "create"]
