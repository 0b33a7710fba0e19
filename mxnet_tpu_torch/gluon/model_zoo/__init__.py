"""Model zoo of the port."""
from . import causal_lm, vision

__all__ = ["causal_lm", "vision"]
