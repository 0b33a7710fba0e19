"""Training-step plumbing of the port: the single-device ``TrainStep``
and ``EvalStep`` (captured as CUDA graphs on the card), their
functional helpers, the ``DevicePrefetcher`` feed and the v1.1
checkpoints (``checkpoint``: ``CheckpointManager``, ``save_train_step``,
``load_train_step``, ``resume_latest``)."""
from .checkpoint import (CheckpointManager, CheckpointMismatchError,
                         list_checkpoints, load_snapshot_params,
                         load_train_step, load_train_step_sharded,
                         resume_latest, save_train_step,
                         save_train_step_sharded, wait_for_new)
from .functional import (functional_call, param_names_and_values,
                         trainable_split)
from .functional_opt import multi_update, pure_update, state_template
from .prefetch import DevicePrefetcher
from .step import EvalStep, NonFiniteAbortError, TrainStep

__all__ = ["TrainStep", "EvalStep", "NonFiniteAbortError", "DevicePrefetcher",
           "functional_call", "param_names_and_values", "trainable_split",
           "pure_update", "multi_update", "state_template",
           "load_train_step", "save_train_step", "load_train_step_sharded",
           "save_train_step_sharded", "CheckpointManager",
           "CheckpointMismatchError", "list_checkpoints", "resume_latest",
           "wait_for_new", "load_snapshot_params"]
