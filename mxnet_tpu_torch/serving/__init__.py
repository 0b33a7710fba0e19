"""Serving runtime of the port: classifier serving (``InferenceServer``
over ``DynamicBatcher``, ``module_apply``, the ``ServingFleet`` with
``WeightUpdater`` and ``FleetAutoscaler``) and LLM generation
(``GenerationServer``), with their admission control (tenant QoS
classes included), circuit breaker and shape buckets.

    from mxnet_tpu_torch import serving

    srv = serving.InferenceServer(apply_fn, buckets=(1, 4, 8),
                                  sample=example).start()
    out = srv(example, deadline=0.1)          # submit + blocking result
    srv.drain()                               # or serve_forever() + SIGTERM

    fleet = serving.ServingFleet.replicated(graphs.captured(fn), params,
                                            3, sample=example).start()
    serving.WeightUpdater(fleet, ckpt_manager).start()   # live weights
    fleet.serve_forever()

On the card an apply fn runs as one captured CUDA graph per bucket
(``parallel.EvalStep``, a hybridized block, ``module_apply``'s executor,
``graphs.captured``), all captured by ``start()`` before readiness
flips; a fleet's replicas share one set of graphs.

    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (CausalLMConfig,
                                                           init_causal_lm)

    cfg = CausalLMConfig(vocab_size=4096, n_layers=4, n_heads=8,
                         head_dim=64, d_ff=2048)
    srv = serving.GenerationServer(init_causal_lm(cfg), cfg,
                                   n_slots=64, n_pages=512, page_size=64,
                                   max_new_tokens=64).start()
    tokens = srv(prompt)

Prompts that share leading blocks share pages (copy-on-write);
``draft=``/``draft_config=`` switch the server to speculative decoding
(``build_verify_step``); a failed step's sequences are salvaged
token-exact; ``drain(handoff=True)`` exports ``SequenceSnapshot``s that
another server (of either package) resumes with ``submit_resume``, as
``restore_journal`` resumes a ``journal=`` file.
"""
from .admission import (RejectedError, CircuitOpenError, ServerClosedError,
                        DeadlineExceededError, NonFiniteOutputError,
                        TenantThrottledError, TokenBucket, Request,
                        QoSClass, ClassStats, TenantQoS)
from .batcher import BucketSpec, DynamicBatcher
from .breaker import CircuitBreaker
from .server import InferenceServer, module_apply
from .fleet import (ServingFleet, ReplicaGroup, HotSwapApply,
                    WeightUpdater, SnapshotRejectedError,
                    SnapshotPrunedError, UpdateRolledBackError,
                    validate_params)
from .generate import (GenerationServer, PageAllocator, PoolExhaustedError,
                       SequenceSnapshot, build_decode_step,
                       build_prefill_step, build_verify_step,
                       prefix_admission_plan)
from .autoscale import FleetAutoscaler, ScalingPolicy

__all__ = ["InferenceServer", "module_apply", "BucketSpec",
           "DynamicBatcher", "CircuitBreaker", "TokenBucket", "Request",
           "RejectedError", "CircuitOpenError", "ServerClosedError",
           "DeadlineExceededError", "NonFiniteOutputError",
           "TenantThrottledError", "QoSClass", "ClassStats", "TenantQoS",
           "ServingFleet", "ReplicaGroup", "HotSwapApply", "WeightUpdater",
           "SnapshotRejectedError", "SnapshotPrunedError",
           "UpdateRolledBackError",
           "validate_params", "GenerationServer", "PageAllocator",
           "PoolExhaustedError", "SequenceSnapshot",
           "prefix_admission_plan", "build_decode_step",
           "build_prefill_step", "build_verify_step",
           "FleetAutoscaler", "ScalingPolicy"]
