"""Optimizers of the port (``Optimizer``, ``SGD``, ``LAMB``, ``create``)."""
from .optimizer import LAMB, SGD, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "LAMB", "create", "register"]
