"""Gluon namespace of the port (the model zoo so far)."""
from . import model_zoo

__all__ = ["model_zoo"]
