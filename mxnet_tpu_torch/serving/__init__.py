"""Serving runtime of the port: LLM generation (``GenerationServer``)
with its admission control, circuit breaker and shape buckets.

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (CausalLMConfig,
                                                           init_causal_lm)

    cfg = CausalLMConfig(vocab_size=4096, n_layers=4, n_heads=8,
                         head_dim=64, d_ff=2048)
    srv = serving.GenerationServer(init_causal_lm(cfg), cfg,
                                   n_slots=64, n_pages=512, page_size=64,
                                   max_new_tokens=64).start()
    tokens = srv(prompt)                      # submit + blocking result
    srv.drain()

Classifier serving (``InferenceServer``, ``DynamicBatcher``) and the
serving fleet are not ported yet.
"""
from .admission import (RejectedError, CircuitOpenError, ServerClosedError,
                        DeadlineExceededError, Request, TokenBucket)
from .batcher import BucketSpec
from .breaker import CircuitBreaker
from .generate import (GenerationServer, PageAllocator, PoolExhaustedError,
                       build_decode_step, build_prefill_step)

__all__ = ["RejectedError", "CircuitOpenError", "ServerClosedError",
           "DeadlineExceededError", "Request", "TokenBucket", "BucketSpec",
           "CircuitBreaker", "GenerationServer", "PageAllocator",
           "PoolExhaustedError", "build_decode_step", "build_prefill_step"]
