"""Optimizers of the port (the eager ``update`` for ``gluon.Trainer``;
``parallel.TrainStep`` runs the JAX step's rules fused), and the
learning-rate schedulers of ``lr_scheduler``, as the JAX package's
``optimizer`` re-exports them."""
from ..lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                            MultiFactorScheduler, PolyScheduler)
from .optimizer import (LAMB, LARS, NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam,
                        Adamax, AdamW, Ftrl, Nadam, Optimizer, RMSProp,
                        Signum, create, register)

Test = None  # the reference's test optimizer; not part of the public API

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "Adamax", "Nadam",
           "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "Signum", "SGLD",
           "LAMB", "LARS", "create", "register", "LRScheduler",
           "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
           "CosineScheduler"]
