"""Training-step plumbing of the port: the single-device ``TrainStep``
and ``EvalStep`` (captured as CUDA graphs on the card) and their
functional helpers."""
from .functional import (functional_call, param_names_and_values,
                         trainable_split)
from .functional_opt import multi_update, pure_update, state_template
from .step import EvalStep, NonFiniteAbortError, TrainStep

__all__ = ["TrainStep", "EvalStep", "NonFiniteAbortError",
           "functional_call", "param_names_and_values", "trainable_split",
           "pure_update", "multi_update", "state_template"]
