"""ONNX export and import (the port of ``mxnet_tpu/onnx``; ref:
python/mxnet/onnx — mx2onnx / onnx2mx).

``export_model`` writes a (Hybrid)Block's inference forward as an ONNX
graph (opset 13, static shapes): the forward traced by ``torch.export``
and decomposed to core aten ops, each mapped onto ONNX nodes, the
protobuf written directly (``proto``; no ``onnx`` package, no
``torch.onnx``).  ``import_to_function`` reads such a file back as a
function on torch tensors, which runs on the device of its inputs.

    mx.onnx.export_model(net, example, "model.onnx")
    fn = mx.onnx.import_to_function("model.onnx")
"""
from .export import export_function, export_model
from .import_ import import_to_function, parse_model

__all__ = ["export_model", "export_function", "import_to_function",
           "parse_model"]
