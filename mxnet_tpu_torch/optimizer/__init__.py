"""Optimizers of the port (the eager ``update`` for ``gluon.Trainer``;
``parallel.TrainStep`` runs the JAX step's rules fused)."""
from .optimizer import (LAMB, LARS, NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam,
                        Adamax, AdamW, Ftrl, Nadam, Optimizer, RMSProp,
                        Signum, create, register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "Adamax", "Nadam",
           "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "Signum", "SGLD",
           "LAMB", "LARS", "create", "register"]
