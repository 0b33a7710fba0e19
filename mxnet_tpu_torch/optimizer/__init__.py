"""Optimizers of the port (the eager ``update`` for ``gluon.Trainer``;
``parallel.TrainStep`` runs SGD and LAMB fused)."""
from .optimizer import (LAMB, NAG, SGD, AdaGrad, Adam, AdamW, Optimizer,
                        RMSProp, create, register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp", "AdaGrad",
           "LAMB", "create", "register"]
