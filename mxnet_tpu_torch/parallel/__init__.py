"""Training-step plumbing of the port: the mesh (``make_mesh``,
``MeshScope``; every axis over the ranks of ``distributed``), the
sharding rules and the sharded leaves they make (``placement``), the
quantized gradient collectives, ``TrainStep`` and ``EvalStep`` (captured
as CUDA graphs on the card; ``mesh=`` and ``rules=`` for data and model
parallelism), sequence parallelism (``ring_attention``,
``ulysses_attention``), the GPipe schedule (``gpipe``,
``PipelineStack``), mixture-of-experts (``moe_dispatch``, ``MoEFFN``),
their functional helpers, the ``DevicePrefetcher`` feed and the v1.1
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
from .mesh import (AXES, MeshScope, current_mesh, default_mesh, make_mesh,
                   named_sharding, replicated, shard_map, validate_specs)
from .sharding import (ShardingRules, batch_spec, causal_lm_tp_rules,
                       fsdp_rules, param_sharding, tp_dense_rules)
from .quantize import (ACTIVATION_REDUCE_MODES, GRAD_REDUCE_MODES,
                       all_reduce_activations, cast_bf16,
                       dequantize_chunked, quantize_chunked,
                       reduce_gradients)
from .prefetch import DevicePrefetcher
from .moe import MoEFFN, moe_dispatch
from .pipeline import PipelineStack, gpipe
from .sequence import ring_attention, sp_attention, ulysses_attention
from .step import (EvalStep, NonFiniteAbortError, TrainStep,
                   add_transfer_hook, remove_transfer_hook)

__all__ = ["TrainStep", "EvalStep", "NonFiniteAbortError", "DevicePrefetcher",
           "functional_call", "param_names_and_values", "trainable_split",
           "pure_update", "multi_update", "state_template",
           "load_train_step", "save_train_step", "load_train_step_sharded",
           "save_train_step_sharded", "CheckpointManager",
           "CheckpointMismatchError", "list_checkpoints", "resume_latest",
           "wait_for_new", "load_snapshot_params",
           "AXES", "MeshScope", "current_mesh", "default_mesh", "make_mesh",
           "named_sharding", "replicated", "shard_map", "validate_specs",
           "ShardingRules", "batch_spec", "fsdp_rules", "param_sharding",
           "tp_dense_rules", "causal_lm_tp_rules",
           "add_transfer_hook", "remove_transfer_hook",
           "GRAD_REDUCE_MODES", "quantize_chunked", "dequantize_chunked",
           "cast_bf16", "reduce_gradients",
           "ACTIVATION_REDUCE_MODES", "all_reduce_activations",
           "ring_attention", "sp_attention", "ulysses_attention",
           "PipelineStack", "gpipe", "MoEFFN", "moe_dispatch"]

