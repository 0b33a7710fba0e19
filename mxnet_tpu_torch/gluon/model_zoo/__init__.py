"""Model zoo of the port."""
from . import bert, causal_lm, language_model, ssd, vision

__all__ = ["bert", "causal_lm", "language_model", "ssd", "vision"]
