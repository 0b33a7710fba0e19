"""Serving runtime of the port: LLM generation (``GenerationServer``)
with its admission control (tenant QoS classes included), circuit
breaker and shape buckets.

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (CausalLMConfig,
                                                           draft_config,
                                                           init_causal_lm)

    cfg = CausalLMConfig(vocab_size=4096, n_layers=4, n_heads=8,
                         head_dim=64, d_ff=2048)
    srv = serving.GenerationServer(init_causal_lm(cfg), cfg,
                                   n_slots=64, n_pages=512, page_size=64,
                                   max_new_tokens=64).start()
    tokens = srv(prompt)                      # submit + blocking result
    srv.drain()

Prompts that share leading blocks share pages (copy-on-write);
``draft=``/``draft_config=`` switch the server to speculative decoding
(``build_verify_step``); a failed step's sequences are salvaged
token-exact; ``drain(handoff=True)`` exports ``SequenceSnapshot``s that
another server (of either package) resumes with ``submit_resume``, as
``restore_journal`` resumes a ``journal=`` file.

Classifier serving (``InferenceServer``, ``DynamicBatcher``), the
serving fleet, disaggregated prefill and tensor parallelism are not
ported yet.
"""
from .admission import (RejectedError, CircuitOpenError, ServerClosedError,
                        DeadlineExceededError, TenantThrottledError,
                        QoSClass, TenantQoS, Request, TokenBucket)
from .batcher import BucketSpec
from .breaker import CircuitBreaker
from .generate import (GenerationServer, PageAllocator, PoolExhaustedError,
                       SequenceSnapshot, build_decode_step,
                       build_prefill_step, build_verify_step,
                       prefix_admission_plan)

__all__ = ["RejectedError", "CircuitOpenError", "ServerClosedError",
           "DeadlineExceededError", "TenantThrottledError", "QoSClass",
           "TenantQoS", "Request", "TokenBucket", "BucketSpec",
           "CircuitBreaker", "GenerationServer", "PageAllocator",
           "PoolExhaustedError", "SequenceSnapshot", "build_decode_step",
           "build_prefill_step", "build_verify_step",
           "prefix_admission_plan"]
