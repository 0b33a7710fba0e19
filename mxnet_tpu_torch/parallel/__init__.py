"""Training-step plumbing of the port: the single-device ``TrainStep``
and its functional helpers."""
from .functional import (functional_call, param_names_and_values,
                         trainable_split)
from .functional_opt import pure_update, state_template
from .step import NonFiniteAbortError, TrainStep

__all__ = ["TrainStep", "NonFiniteAbortError", "functional_call",
           "param_names_and_values", "trainable_split", "pure_update",
           "state_template"]
