"""Model zoo of the port."""
from . import bert, causal_lm, vision

__all__ = ["bert", "causal_lm", "vision"]
