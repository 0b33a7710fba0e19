"""Model zoo of the port."""
from . import bert, causal_lm, language_model, ssd, vision
from .vision import get_model

__all__ = ["bert", "causal_lm", "language_model", "ssd", "vision",
           "get_model"]
