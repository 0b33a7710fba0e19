"""``mx.amp`` of the port: so far only the post-training int8 weight
quantization that int8 serving uses (``amp.quantize``:
``quantize_weight``, ``dequantize_weight``, ``Int8Quantizer``).  The
mixed-precision rewriting (``init``, ``init_trainer``, ``scale_loss``,
``convert_model``, the loss scaler) is not ported yet (ROADMAP A14).
"""
from .quantize import Int8Quantizer, dequantize_weight, quantize_weight

__all__ = ["Int8Quantizer", "quantize_weight", "dequantize_weight"]
