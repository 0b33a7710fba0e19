"""Optimizers of the port (``Optimizer``, ``SGD``, ``create``)."""
from .optimizer import SGD, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "create", "register"]
