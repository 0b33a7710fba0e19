"""Model zoo of the port."""
from . import causal_lm

__all__ = ["causal_lm"]
