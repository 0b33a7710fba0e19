"""AMP cast lists (the JAX package's ``amp/lists.py``, copied; ref:
python/mxnet/amp/lists/symbol_fp16.py — FP16_FUNCS / FP16_FP32_FUNCS /
FP32_FUNCS / WIDEST_TYPE_CASTS).

Categories:
- TARGET_DTYPE_OPS: run in the low-precision target (the tensor-core matmul/conv
  families — the reference's FP16_FUNCS).
- FP32_OPS: numerically sensitive, forced to float32 (softmax/norm/exp/...).
- WIDEST_OPS: elementwise ops cast to the widest input dtype so mixed
  operands don't silently truncate.
Everything else runs in whatever dtype its inputs already have.
"""

TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "dot", "batch_dot",
    "linalg_gemm", "linalg_gemm2", "RNN",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "multi_head_attention", "flash_attention",
    "quantized_matmul", "quantized_fully_connected",
]

FP32_OPS = [
    "softmax", "log_softmax", "softmin", "SoftmaxOutput",
    "softmax_cross_entropy", "CTCLoss", "smooth_l1",
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "RMSNorm",
    "L2Normalization", "norm", "exp", "expm1", "log", "log2", "log10",
    "log1p", "rsqrt", "sqrt", "square", "reciprocal", "rcbrt", "cbrt",
    "pow", "power", "gamma", "gammaln", "erf", "erfinv", "sum", "mean",
    "nansum", "prod", "nanprod", "cumsum", "cumprod", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh_fp32_guard",
]

WIDEST_OPS = [
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "mod",
    "hypot", "broadcast_add", "broadcast_sub", "broadcast_mul",
    "broadcast_div", "Concat", "stack", "where", "clip",
]
