"""ONNX model reader and evaluator on torch tensors (the port of
``mxnet_tpu/onnx/import_.py``; ref: python/mxnet/onnx, the onnx2mx
path).

``parse_model`` reads the binary directly (no onnx package);
``import_to_function`` returns ``fn(*inputs) -> list of tensors`` that
evaluates the graph with torch ops on the device of its first tensor
input, else on ``current_context()``'s (the initializers are copied
there once per device).  The integer initializers that a node reads as
a shape, axes, pads or slice bounds stay on the host, so a call reads
no value back from the card.  It reads what either package's exporter
writes, and small third-party inference models of the same ops.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

from . import proto

_TORCH_DTYPE = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                5: torch.int16, 6: torch.int32, 7: torch.int64,
                9: torch.bool, 10: torch.float16, 11: torch.float64,
                16: torch.bfloat16}
_NP_DTYPE = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
             6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
             11: np.float64, 16: np.int16}


def _parse_tensor(buf):
    """``(name, tensor)`` of a TensorProto (on the host)."""
    dims, dtype, name, raw = [], 1, "", b""
    i32, i64, f32 = [], [], []
    for num, wt, v in proto.parse(buf):
        if num == 1 and wt == 2:
            dims.extend(proto.parse_packed_varints(v))
        elif num == 1 and wt == 0:
            dims.append(proto.unzigzag_int64(v))
        elif num == 2:
            dtype = v
        elif num == 8:
            name = v.decode()
        elif num == 9:
            raw = v
        elif num == 4 and wt == 5:
            f32.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif num == 4 and wt == 2:
            f32.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif num == 5 and wt == 2:
            i32.extend(proto.parse_packed_varints(v))
        elif num == 7 and wt == 2:
            i64.extend(proto.parse_packed_varints(v))
    np_dt = _NP_DTYPE.get(dtype)
    if np_dt is None:
        raise ValueError(f"tensor {name!r}: unsupported ONNX dtype {dtype}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dt).reshape(dims).copy()
    elif f32:
        arr = np.asarray(f32, np_dt).reshape(dims)
    elif i64 or i32:
        arr = np.asarray(i64 or i32, np_dt).reshape(dims)
    else:
        arr = np.zeros(dims, np_dt)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return name, t.view(torch.bfloat16) if dtype == 16 else t


def _parse_attr(buf):
    name, val = "", None
    fields = {}
    ints = []
    for num, wt, v in proto.parse(buf):
        if num == 1:
            name = v.decode()
        elif num == 2:
            fields["f"] = struct.unpack("<f", struct.pack("<I", v))[0]
        elif num == 3:
            fields["i"] = proto.unzigzag_int64(v)
        elif num == 4:
            fields["s"] = v.decode()
        elif num == 5:
            fields["t"] = _parse_tensor(v)[1]
        elif num == 8 and wt == 2:
            ints.extend(proto.parse_packed_varints(v))
        elif num == 8 and wt == 0:
            ints.append(proto.unzigzag_int64(v))
    if ints:
        val = ints
    else:
        for k in ("i", "f", "s", "t"):
            if k in fields:
                val = fields[k]
                break
    return name, val


def _parse_node(buf):
    inputs, outputs, op_type, attrs = [], [], "", {}
    for num, wt, v in proto.parse(buf):
        if num == 1:
            inputs.append(v.decode())
        elif num == 2:
            outputs.append(v.decode())
        elif num == 4:
            op_type = v.decode()
        elif num == 5:
            k, val = _parse_attr(v)
            attrs[k] = val
    return op_type, inputs, outputs, attrs


def _parse_value_info_name(buf):
    for num, wt, v in proto.parse(buf):
        if num == 1:
            return v.decode()
    return ""


def parse_model(path):
    """``(nodes, initializers, input_names, output_names)``; the
    initializers are host tensors."""
    with open(path, "rb") as f:
        data = f.read()
    graph = None
    for num, wt, v in proto.parse(data):
        if num == 7:
            graph = v
    if graph is None:
        raise ValueError("no GraphProto in model")
    nodes, inits, ins, outs = [], {}, [], []
    for num, wt, v in proto.parse(graph):
        if num == 1:
            nodes.append(_parse_node(v))
        elif num == 5:
            name, arr = _parse_tensor(v)
            inits[name] = arr
        elif num == 11:
            ins.append(_parse_value_info_name(v))
        elif num == 12:
            outs.append(_parse_value_info_name(v))
    return nodes, inits, ins, outs


# --- evaluator -------------------------------------------------------------


def _ints(t):
    return [int(v) for v in t.reshape(-1).tolist()]


# The input slots that ``_eval_node`` reads on the host (``_ints``, the
# Pad value): an initializer there is passed as its host tensor.
_HOST_SLOTS = {"Reshape": (1,), "Squeeze": (1,), "Unsqueeze": (1,),
               "Expand": (1,), "Slice": (1, 2, 3, 4), "Pad": (1, 2),
               "ReduceSum": (1,), "ReduceMean": (1,), "ReduceMax": (1,),
               "ReduceMin": (1,)}


def _pads(x, pads, nsp, value):
    """Pad the spatial axes of ``x`` by ONNX's [begins..., ends...]."""
    if not pads or not any(pads):
        return x
    flat = []
    for i in reversed(range(nsp)):
        flat += [pads[i], pads[i + nsp]]
    return F.pad(x, flat, value=value)


def _pool(x, kernel, strides, pads, op, count_include_pad, ceil_mode):
    nsp = len(kernel)
    strides = list(strides or [1] * nsp)
    fns = {1: (F.max_pool1d, F.avg_pool1d), 2: (F.max_pool2d, F.avg_pool2d),
           3: (F.max_pool3d, F.avg_pool3d)}[nsp]
    if op == "max":
        fill = -math.inf if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        return fns[0](_pads(x, pads, nsp, fill), kernel, strides,
                      ceil_mode=ceil_mode)
    s = fns[1](_pads(x, pads, nsp, 0.0), kernel, strides,
               ceil_mode=ceil_mode) * float(math.prod(kernel))
    if count_include_pad:
        return s / float(math.prod(kernel))
    ones = torch.ones_like(x[:1, :1])
    cnt = fns[1](_pads(ones, pads, nsp, 0.0), kernel, strides,
                 ceil_mode=ceil_mode) * float(math.prod(kernel))
    return s / cnt


def _conv(x, w, b, a):
    nsp = x.dim() - 2
    fn = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nsp]
    x = _pads(x, a("pads"), nsp, 0.0)
    out = fn(x, w, b, stride=a("strides") or 1, dilation=a("dilations") or 1,
             groups=a("group", 1))
    return out


def _reduce(fn, x, ins, a, keep_default=1):
    axes = _ints(ins[1]) if len(ins) > 1 and ins[1] is not None \
        else (a("axes") or list(range(x.dim())))
    keep = bool(a("keepdims", keep_default))
    return fn(x, dim=tuple(d % max(x.dim(), 1) for d in axes), keepdim=keep)


def _eval_node(op, ins, attrs):
    a = attrs.get
    x = ins[0] if ins else None
    if op == "Identity":
        return x
    if op in ("Add", "Sub", "Mul", "Div"):
        fn = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
              "Div": torch.div}[op]
        out = fn(x, ins[1])
        if op == "Div" and not x.is_floating_point():
            out = torch.div(x, ins[1], rounding_mode="trunc")
        return out
    if op == "Mod":
        return torch.fmod(x, ins[1]) if a("fmod", 0) else \
            torch.remainder(x, ins[1])
    if op in ("Max", "Min"):
        fn = torch.maximum if op == "Max" else torch.minimum
        out = ins[0]
        for y in ins[1:]:
            out = fn(out, y)
        return out
    unary = {"Neg": torch.neg, "Exp": torch.exp, "Log": torch.log,
             "Tanh": torch.tanh, "Sqrt": torch.sqrt, "Abs": torch.abs,
             "Sign": torch.sign, "Floor": torch.floor, "Ceil": torch.ceil,
             "Sin": torch.sin, "Cos": torch.cos, "Round": torch.round,
             "Erf": torch.erf, "Sigmoid": torch.sigmoid,
             "Reciprocal": torch.reciprocal, "Not": torch.logical_not,
             "Relu": torch.relu}
    if op in unary:
        return unary[op](x)
    if op == "Pow":
        return torch.pow(x, ins[1])
    cmp = {"Equal": torch.eq, "Greater": torch.gt, "Less": torch.lt,
           "GreaterOrEqual": torch.ge, "LessOrEqual": torch.le}
    if op in cmp:
        return cmp[op](x, ins[1])
    if op == "Where":
        return torch.where(x.bool(), ins[1], ins[2])
    if op == "Clip":
        out = x
        if len(ins) > 1 and ins[1] is not None:
            out = torch.maximum(out, ins[1].to(out.dtype))
        if len(ins) > 2 and ins[2] is not None:
            out = torch.minimum(out, ins[2].to(out.dtype))
        return out
    if op == "Cast":
        return x.to(_TORCH_DTYPE[a("to")])
    if op == "Transpose":
        perm = a("perm") or list(reversed(range(x.dim())))
        return x.permute(perm)
    if op == "Reshape":
        shape = _ints(ins[1])
        shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
        return x.reshape(shape)
    if op == "Squeeze":
        axes = _ints(ins[1]) if len(ins) > 1 and ins[1] is not None \
            else (a("axes") or [i for i, s in enumerate(x.shape) if s == 1])
        return x.squeeze(tuple(d % x.dim() for d in axes))
    if op == "Unsqueeze":
        axes = _ints(ins[1]) if len(ins) > 1 and ins[1] is not None \
            else a("axes")
        nd = x.dim() + len(axes)
        for d in sorted(d % nd for d in axes):
            x = x.unsqueeze(d)
        return x
    if op == "Expand":
        shape = torch.broadcast_shapes(tuple(_ints(ins[1])), x.shape)
        return torch.broadcast_to(x, shape)
    if op == "Concat":
        return torch.cat(ins, dim=a("axis"))
    if op == "Slice":
        starts, ends = _ints(ins[1]), _ints(ins[2])
        axes = _ints(ins[3]) if len(ins) > 3 and ins[3] is not None \
            else list(range(len(starts)))
        steps = _ints(ins[4]) if len(ins) > 4 and ins[4] is not None \
            else [1] * len(starts)
        for s, e, ax, st in zip(starts, ends, axes, steps):
            n = x.shape[ax]
            if st > 0:
                s = max(0, min(n, s + n if s < 0 else s))
                e = max(0, min(n, e + n if e < 0 else e))
                x = x.narrow(ax, s, max(0, e - s))
                if st != 1:
                    idx = torch.arange(0, x.shape[ax], st, device=x.device)
                    x = x.index_select(ax, idx)
            else:
                s = min(n - 1, s + n if s < 0 else s)
                e = -1 if e < -n else (e + n if e < 0 else e)
                idx = torch.arange(s, e, st, device=x.device)
                x = x.index_select(ax, idx)
        return x
    if op == "Pad":
        pads = _ints(ins[1])
        n = len(pads) // 2
        cval = float(ins[2].reshape(())) if len(ins) > 2 and \
            ins[2] is not None else 0.0
        flat = []
        for i in reversed(range(n)):
            flat += [pads[i], pads[i + n]]
        return F.pad(x, flat, value=cval)
    if op == "ReduceSum":
        return _reduce(torch.sum, x, ins, a)
    if op == "ReduceMean":
        return _reduce(torch.mean, x, ins, a)
    if op == "ReduceMax":
        return _reduce(torch.amax, x, ins, a)
    if op == "ReduceMin":
        return _reduce(torch.amin, x, ins, a)
    if op == "ReduceProd":
        out = x
        axes = a("axes") or list(range(x.dim()))
        for d in sorted((d % x.dim() for d in axes), reverse=True):
            out = out.prod(d, keepdim=bool(a("keepdims", 1)))
        return out
    if op == "ArgMax":
        return torch.argmax(x, dim=a("axis", 0),
                            keepdim=bool(a("keepdims", 1)))
    if op == "MatMul":
        return torch.matmul(x, ins[1])
    if op == "Gemm":
        xx = x.T if a("transA") else x
        w = ins[1].T if a("transB") else ins[1]
        out = a("alpha", 1.0) * (xx @ w)
        if len(ins) > 2 and ins[2] is not None:
            out = out + a("beta", 1.0) * ins[2]
        return out
    if op == "Conv":
        return _conv(x, ins[1], ins[2] if len(ins) > 2 else None, a)
    if op == "MaxPool":
        return _pool(x, a("kernel_shape"), a("strides"), a("pads"), "max",
                     True, bool(a("ceil_mode", 0)))
    if op == "AveragePool":
        return _pool(x, a("kernel_shape"), a("strides"), a("pads"), "avg",
                     bool(a("count_include_pad", 0)),
                     bool(a("ceil_mode", 0)))
    if op == "Softmax":
        return torch.softmax(x, dim=a("axis", -1))
    if op == "LogSoftmax":
        return torch.log_softmax(x, dim=a("axis", -1))
    if op == "LeakyRelu":
        return F.leaky_relu(x, a("alpha", 0.01))
    if op == "Gather":
        idx = ins[1].long()
        ax = a("axis", 0) % x.dim()
        idx = torch.where(idx < 0, idx + x.shape[ax], idx)
        out = x.index_select(ax, idx.reshape(-1))
        return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])
    if op == "Flatten":
        ax = a("axis", 1)
        return x.reshape((int(math.prod(x.shape[:ax])), -1))
    raise NotImplementedError(f"ONNX import: unsupported op {op!r}")


def _as_input(x, device):
    """A tensor or NDArray as it is; anything else (numpy arrays, lists)
    as a tensor on ``device``."""
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def import_to_function(path):
    """Load an ONNX file -> ``fn(*inputs) -> list of tensors``; the
    inputs are tensors, NDArrays or numpy arrays.  The graph runs on the
    first tensor input's device, else on ``current_context()``'s, where
    the numpy inputs go too."""
    from ..context import current_context
    from ..ndarray.ndarray import NDArray
    nodes, inits, in_names, out_names = parse_model(path)
    host = [[inits[n] if n in inits and k in _HOST_SLOTS.get(op, ()) else
             None for k, n in enumerate(ins)] for op, ins, _, _ in nodes]
    on_device = {}

    def fn(*inputs):
        tensors = [x._data if isinstance(x, NDArray) else x for x in inputs
                   if isinstance(x, (NDArray, torch.Tensor))]
        dev = tensors[0].device if tensors else current_context().device
        xs = [_as_input(x, dev) for x in inputs]
        consts = on_device.get(dev)
        if consts is None:
            consts = on_device[dev] = {k: v.to(dev)
                                       for k, v in inits.items()}
        env = dict(consts)
        env.update(zip(in_names, xs))
        with torch.no_grad():
            for (op, ins, outs, attrs), pinned in zip(nodes, host):
                # an empty name is an omitted optional input: the slot
                # stays None so later inputs keep their positions
                env[outs[0]] = _eval_node(
                    op, [h if h is not None else env[i] if i else None
                         for i, h in zip(ins, pinned)], dict(attrs))
        return [env[o] for o in out_names]

    return fn
