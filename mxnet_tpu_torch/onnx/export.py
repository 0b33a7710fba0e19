"""ONNX export: core-aten graph -> ONNX graph (the port of
``mxnet_tpu/onnx/export.py``; ref: python/mxnet/onnx/mx2onnx/).

The JAX exporter maps the jaxpr of a block's functional forward onto
ONNX nodes.  The port's captured graph is the aten graph of the same
forward (``HybridBlock.export``'s ``_Serve``: the parameters passed
in, inference mode), traced on fake tensors and decomposed to core
aten ops (``make_fx`` with the core decomposition table, the graph
``torch.export``'s ``run_decompositions`` gives), and each op maps onto
opset-13 nodes.  The ops chosen are those the JAX package's importer reads (a mean is a
``ReduceSum`` and a ``Div``, ``rsqrt`` a ``Reciprocal`` of a ``Sqrt``),
so either package's importer reads either package's file.

Scope: inference graphs, opset 13, static shapes, bf16 as ONNX code 16.
An op with no translator raises ``NotImplementedError`` naming it; so do
the hand-written kernels' ``mxnet_tpu_torch::`` ops (the JAX exporter
raises on ``pallas_call``).
"""
from __future__ import annotations

import math
import operator

import numpy as np
import torch

from . import proto

# --- ONNX dtype codes ------------------------------------------------------

_DTYPE = {torch.float32: 1, torch.uint8: 2, torch.int8: 3, torch.int16: 5,
          torch.int32: 6, torch.int64: 7, torch.bool: 9, torch.float16: 10,
          torch.float64: 11, torch.bfloat16: 16}


def _onnx_dtype(dt) -> int:
    try:
        return _DTYPE[dt]
    except KeyError:
        raise ValueError(f"dtype {dt} has no ONNX mapping") from None


# --- proto encoders --------------------------------------------------------


def _raw_bytes(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes()
    return t.numpy().tobytes()


def _tensor(name, t):
    """A TensorProto of tensor (or numpy array) ``t``."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return (proto.field_packed_varints(1, list(t.shape))
            + proto.field_varint(2, _onnx_dtype(t.dtype))
            + proto.field_str(8, name)
            + proto.field_bytes(9, _raw_bytes(t)))


def _attr(name, value):
    out = proto.field_str(1, name)
    if isinstance(value, bool):
        out += proto.field_varint(3, int(value)) + proto.field_varint(20, 2)
    elif isinstance(value, int):
        out += proto.field_varint(3, value) + proto.field_varint(20, 2)
    elif isinstance(value, float):
        out += proto.field_float(2, value) + proto.field_varint(20, 1)
    elif isinstance(value, str):
        out += proto.field_bytes(4, value.encode()) + proto.field_varint(20, 3)
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, (int, np.integer)) for v in value):
        out += proto.field_packed_varints(8, [int(v) for v in value])
        out += proto.field_varint(20, 7)
    else:
        raise TypeError(f"attribute {name}: unsupported {type(value)}")
    return out


def _node(op_type, inputs, outputs, name, attrs):
    out = b"".join(proto.field_str(1, i) for i in inputs)
    out += b"".join(proto.field_str(2, o) for o in outputs)
    out += proto.field_str(3, name) + proto.field_str(4, op_type)
    out += b"".join(proto.field_bytes(5, _attr(k, v))
                    for k, v in attrs.items())
    return out


def _value_info(name, shape, dtype):
    dims = b"".join(
        proto.field_bytes(1, proto.field_varint(1, int(d))) for d in shape)
    tensor_type = (proto.field_varint(1, _onnx_dtype(dtype))
                   + proto.field_bytes(2, dims))
    return (proto.field_str(1, name)
            + proto.field_bytes(2, proto.field_bytes(1, tensor_type)))


# --- the graph --------------------------------------------------------


class _Graph:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self._n = 0

    def name(self, hint):
        self._n += 1
        return f"{hint}_{self._n}"

    def node(self, op_type, inputs, outputs=None, **attrs):
        if outputs is None:
            outputs = [self.name(op_type.lower())]
        self.nodes.append(_node(op_type, inputs, outputs,
                                self.name(op_type), attrs))
        return outputs[0]

    def const(self, value, dtype, hint="const"):
        name = self.name(hint)
        t = value.detach() if isinstance(value, torch.Tensor) else \
            torch.tensor(value)
        self.inits.append(_tensor(name, t.to(dtype)))
        return name

    def const_i64(self, values, hint="shape"):
        return self.const(torch.tensor(list(values), dtype=torch.int64),
                          torch.int64, hint)


# --- aten translators ------------------------------------------------------

_aten = torch.ops.aten
_HANDLERS = {}


def _reg(*ops):
    def deco(fn):
        for op in ops:
            _HANDLERS[op] = fn
        return fn
    return deco


def _val(node):
    return node.meta["val"]


class _Ctx:
    """What a translator sees: the node, its argument names and metas."""

    def __init__(self, g, node, env):
        self.g, self.node, self.env = g, node, env

    def out(self):
        return _val(self.node)

    def arg(self, i, dtype=None):
        """Argument ``i`` as an ONNX name: a graph value, or a constant of
        ``dtype`` (default: the output's) for a Python scalar."""
        a = self.node.args[i] if i < len(self.node.args) else None
        return self.name_of(a, dtype)

    def name_of(self, a, dtype=None):
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        dt = dtype or self.out().dtype
        return self.g.const(a, dt, "lit")

    def meta(self, i):
        return _val(self.node.args[i])

    def kw(self, i, name, default=None):
        args = self.node.args
        if i < len(args):
            return args[i]
        return self.node.kwargs.get(name, default)


def _unsupported(target, extra=""):
    return NotImplementedError(
        f"ONNX export: no translator for aten op '{_op_name(target)}'"
        f"{' — ' + extra if extra else ''} (ref: mx2onnx unsupported-op "
        f"contract)")


def _op_name(target):
    return getattr(target, "name", lambda: str(target))() \
        if callable(getattr(target, "name", None)) else str(target)


def _simple(op_type, *ops):
    @_reg(*ops)
    def _h(c):
        return c.g.node(op_type, [c.arg(0)])


_simple("Neg", _aten.neg.default)
_simple("Exp", _aten.exp.default)
_simple("Log", _aten.log.default)
_simple("Tanh", _aten.tanh.default)
_simple("Sigmoid", _aten.sigmoid.default)
_simple("Sqrt", _aten.sqrt.default)
_simple("Abs", _aten.abs.default)
_simple("Sign", _aten.sign.default)
_simple("Floor", _aten.floor.default)
_simple("Ceil", _aten.ceil.default)
_simple("Round", _aten.round.default)
_simple("Erf", _aten.erf.default)
_simple("Sin", _aten.sin.default)
_simple("Cos", _aten.cos.default)
_simple("Relu", _aten.relu.default)
_simple("Reciprocal", _aten.reciprocal.default)
_simple("Not", _aten.logical_not.default, _aten.bitwise_not.default)
_simple("Identity", _aten.clone.default, _aten.alias.default,
        _aten.detach.default, _aten.lift_fresh_copy.default)


def _binary(op_type, *ops, cmp=False):
    @_reg(*ops)
    def _h(c):
        dt = None
        if cmp:     # a scalar takes the tensor operand's dtype
            t = c.node.args[0] if isinstance(c.node.args[0], torch.fx.Node) \
                else c.node.args[1]
            dt = _val(t).dtype
        return c.g.node(op_type, [c.arg(0, dt), c.arg(1, dt)])


_binary("Mul", _aten.mul.Tensor, _aten.mul.Scalar)
_binary("Div", _aten.div.Tensor, _aten.div.Scalar)
_binary("Max", _aten.maximum.default)
_binary("Min", _aten.minimum.default)
_binary("Pow", _aten.pow.Tensor_Tensor, _aten.pow.Tensor_Scalar)
_binary("Equal", _aten.eq.Tensor, _aten.eq.Scalar, cmp=True)
_binary("Greater", _aten.gt.Tensor, _aten.gt.Scalar, cmp=True)
_binary("Less", _aten.lt.Tensor, _aten.lt.Scalar, cmp=True)
_binary("GreaterOrEqual", _aten.ge.Tensor, _aten.ge.Scalar, cmp=True)
_binary("LessOrEqual", _aten.le.Tensor, _aten.le.Scalar, cmp=True)


@_reg(_aten.add.Tensor, _aten.add.Scalar, _aten.sub.Tensor, _aten.sub.Scalar)
def _add_sub(c):
    b = c.arg(1)
    alpha = c.node.kwargs.get("alpha", 1)
    if alpha != 1:
        b = c.g.node("Mul", [b, c.g.const(alpha, c.out().dtype, "alpha")])
    op = "Add" if c.node.target in (_aten.add.Tensor, _aten.add.Scalar) \
        else "Sub"
    return c.g.node(op, [c.arg(0), b])


@_reg(_aten.ne.Tensor, _aten.ne.Scalar)
def _ne(c):
    t = c.node.args[0]
    dt = _val(t).dtype
    return c.g.node("Not", [c.g.node("Equal", [c.arg(0, dt), c.arg(1, dt)])])


@_reg(_aten.rsqrt.default)
def _rsqrt(c):
    return c.g.node("Reciprocal", [c.g.node("Sqrt", [c.arg(0)])])


@_reg(_aten.fmod.Tensor, _aten.fmod.Scalar)
def _fmod(c):
    return c.g.node("Mod", [c.arg(0), c.arg(1)], fmod=1)


@_reg(_aten.gelu.default)
def _gelu(c):
    if c.node.kwargs.get("approximate", "none") != "none":
        raise _unsupported(c.node.target, "tanh-approximate gelu")
    dt = c.out().dtype
    x = c.arg(0)
    erf = c.g.node("Erf", [c.g.node("Div", [x, c.g.const(math.sqrt(2.0),
                                                         dt)])])
    half = c.g.node("Mul", [x, c.g.const(0.5, dt)])
    return c.g.node("Mul", [half, c.g.node("Add", [erf, c.g.const(1.0,
                                                                  dt)])])


@_reg(_aten.leaky_relu.default)
def _leaky(c):
    slope = c.kw(1, "negative_slope", 0.01)
    return c.g.node("LeakyRelu", [c.arg(0)], alpha=float(slope))


@_reg(_aten.clamp.default, _aten.hardtanh.default)
def _clamp(c):
    lo, hi = c.kw(1, "min"), c.kw(2, "max")
    if c.node.target == _aten.hardtanh.default:
        lo, hi = c.kw(1, "min_val", -1.0), c.kw(2, "max_val", 1.0)
    dt = c.out().dtype
    ins = [c.arg(0), "" if lo is None else c.g.const(lo, dt, "min"),
           "" if hi is None else c.g.const(hi, dt, "max")]
    return c.g.node("Clip", ins)


@_reg(_aten.where.self)
def _where(c):
    return c.g.node("Where", [c.arg(0, torch.bool), c.arg(1), c.arg(2)])


@_reg(_aten._to_copy.default)
def _cast(c):
    return c.g.node("Cast", [c.arg(0)], to=_onnx_dtype(c.out().dtype))


@_reg(_aten.view.default, _aten._unsafe_view.default, _aten.reshape.default)
def _reshape(c):
    return c.g.node("Reshape", [c.arg(0), c.g.const_i64(c.out().shape)])


@_reg(_aten.expand.default)
def _expand(c):
    return c.g.node("Expand", [c.arg(0), c.g.const_i64(c.out().shape)])


@_reg(_aten.permute.default)
def _permute(c):
    nd = c.meta(0).dim()
    return c.g.node("Transpose", [c.arg(0)],
                    perm=[d % nd for d in c.node.args[1]])


@_reg(_aten.unsqueeze.default)
def _unsqueeze(c):
    nd = c.out().dim()
    return c.g.node("Unsqueeze", [c.arg(0), c.g.const_i64(
        [c.node.args[1] % nd], "axes")])


@_reg(_aten.squeeze.dim, _aten.squeeze.dims)
def _squeeze(c):
    nd = c.meta(0).dim()
    dims = c.node.args[1]
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = [d % nd for d in dims if c.meta(0).shape[d] == 1]
    if not dims:
        return c.g.node("Identity", [c.arg(0)])
    return c.g.node("Squeeze", [c.arg(0), c.g.const_i64(dims, "axes")])


@_reg(_aten.cat.default)
def _cat(c):
    nd = c.out().dim()
    ins = [c.env[a] for a in c.node.args[0]]
    return c.g.node("Concat", ins, axis=c.kw(1, "dim", 0) % nd)


@_reg(_aten.slice.Tensor)
def _slice(c):
    shape = c.meta(0).shape
    dim = c.kw(1, "dim", 0) % len(shape)
    start = c.kw(2, "start", 0) or 0
    end = c.kw(3, "end", None)
    step = c.kw(4, "step", 1)
    n = shape[dim]
    end = n if end is None else min(end, n)
    return c.g.node("Slice", [c.arg(0), c.g.const_i64([start], "starts"),
                              c.g.const_i64([end], "ends"),
                              c.g.const_i64([dim], "axes"),
                              c.g.const_i64([step], "steps")])


@_reg(_aten.constant_pad_nd.default)
def _pad(c):
    nd = c.meta(0).dim()
    pad = list(c.node.args[1])
    value = c.kw(2, "value", 0.0)
    if any(p < 0 for p in pad):
        raise _unsupported(c.node.target, "negative padding")
    lo, hi = [0] * nd, [0] * nd
    for i in range(len(pad) // 2):
        lo[nd - 1 - i], hi[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
    return c.g.node("Pad", [c.arg(0), c.g.const_i64(lo + hi, "pads"),
                            c.g.const(value, c.out().dtype, "value")])


def _axes(c, i, name):
    nd = c.meta(0).dim()
    dims = c.kw(i, name)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(nd))
    dims = [dims] if isinstance(dims, int) else list(dims)
    return [d % nd for d in dims]


@_reg(_aten.sum.dim_IntList)
def _sum(c):
    # opset 13: ReduceSum (alone among the reduces) takes axes as an input
    return c.g.node("ReduceSum", [c.arg(0), c.g.const_i64(
        _axes(c, 1, "dim"), "axes")], keepdims=int(c.kw(2, "keepdim",
                                                          False)))


@_reg(_aten.mean.dim)
def _mean(c):
    axes = _axes(c, 1, "dim")
    s = c.g.node("ReduceSum", [c.arg(0), c.g.const_i64(axes, "axes")],
                 keepdims=int(c.kw(2, "keepdim", False)))
    n = math.prod(c.meta(0).shape[a] for a in axes)
    return c.g.node("Div", [s, c.g.const(float(n), c.out().dtype, "count")])


def _reduce_attr(op_type):
    def h(c):
        # opset 13: ReduceMax/Min/Prod take axes as an ATTRIBUTE
        return c.g.node(op_type, [c.arg(0)], axes=_axes(c, 1, "dim"),
                        keepdims=int(c.kw(2, "keepdim", False)))
    return h


_reg(_aten.amax.default)(_reduce_attr("ReduceMax"))
_reg(_aten.amin.default)(_reduce_attr("ReduceMin"))


@_reg(_aten.argmax.default)
def _argmax(c):
    dim = c.kw(1, "dim")
    if dim is None:
        raise _unsupported(c.node.target, "argmax over all axes")
    out = c.g.node("ArgMax", [c.arg(0)], axis=dim % c.meta(0).dim(),
                   keepdims=int(c.kw(2, "keepdim", False)))
    return c.g.node("Cast", [out], to=_onnx_dtype(c.out().dtype))


@_reg(_aten.mm.default, _aten.bmm.default)
def _mm(c):
    return c.g.node("MatMul", [c.arg(0), c.arg(1)])


@_reg(_aten.addmm.default)
def _addmm(c):
    if c.node.kwargs.get("beta", 1) != 1 or c.node.kwargs.get("alpha", 1) != 1:
        raise _unsupported(c.node.target, "beta/alpha")
    return c.g.node("Add", [c.g.node("MatMul", [c.arg(1), c.arg(2)]),
                            c.arg(0)])


@_reg(_aten.convolution.default)
def _conv(c):
    (x, w, b, stride, padding, dilation, transposed, _out_pad,
     groups) = c.node.args
    if transposed:
        raise _unsupported(c.node.target, "transposed convolution")
    ins = [c.env[x], c.env[w]] + ([c.env[b]] if b is not None else [])
    return c.g.node("Conv", ins, strides=list(stride),
                    pads=list(padding) + list(padding),
                    dilations=list(dilation), group=int(groups))


@_reg(_aten.max_pool2d_with_indices.default)
def _maxpool(c):
    args = c.node.args
    kernel = list(args[1])
    stride = list(args[2]) if len(args) > 2 and args[2] else kernel
    padding = list(args[3]) if len(args) > 3 else [0, 0]
    dilation = list(args[4]) if len(args) > 4 else [1, 1]
    ceil_mode = bool(args[5]) if len(args) > 5 else False
    if dilation != [1, 1]:
        raise _unsupported(c.node.target, "dilated pooling")
    out = c.g.node("MaxPool", [c.arg(0)], kernel_shape=kernel,
                   strides=stride, pads=padding + padding,
                   ceil_mode=int(ceil_mode))
    return [out, None]


@_reg(_aten.avg_pool2d.default)
def _avgpool(c):
    args = c.node.args
    kernel = list(args[1])
    stride = list(args[2]) if len(args) > 2 and args[2] else kernel
    padding = list(args[3]) if len(args) > 3 else [0, 0]
    ceil_mode = bool(args[4]) if len(args) > 4 else False
    include = bool(args[5]) if len(args) > 5 else True
    if len(args) > 6 and args[6] is not None:
        raise _unsupported(c.node.target, "divisor_override")
    return c.g.node("AveragePool", [c.arg(0)], kernel_shape=kernel,
                    strides=stride, pads=padding + padding,
                    ceil_mode=int(ceil_mode), count_include_pad=int(include))


@_reg(_aten._softmax.default)
def _softmax(c):
    return c.g.node("Softmax", [c.arg(0)], axis=c.node.args[1])


@_reg(_aten._log_softmax.default)
def _log_softmax(c):
    return c.g.node("LogSoftmax", [c.arg(0)], axis=c.node.args[1])


@_reg(_aten.index_select.default)
def _index_select(c):
    return c.g.node("Gather", [c.arg(0), c.arg(2)],
                    axis=c.node.args[1] % c.meta(0).dim())


@_reg(_aten.embedding.default)
def _embedding(c):
    return c.g.node("Gather", [c.arg(0), c.arg(1)], axis=0)


@_reg(_aten.select.int)
def _select(c):
    dim = c.node.args[1] % c.meta(0).dim()
    idx = c.g.const(torch.tensor(c.node.args[2]), torch.int64, "index")
    return c.g.node("Gather", [c.arg(0), idx], axis=dim)


@_reg(_aten.split_with_sizes.default)
def _split(c):
    sizes = list(c.node.args[1])
    dim = c.kw(2, "dim", 0) % c.meta(0).dim()
    outs, start = [], 0
    for s in sizes:
        outs.append(c.g.node("Slice", [
            c.arg(0), c.g.const_i64([start], "starts"),
            c.g.const_i64([start + s], "ends"), c.g.const_i64([dim], "axes"),
            c.g.const_i64([1], "steps")]))
        start += s
    return outs


@_reg(_aten.full.default, _aten.scalar_tensor.default, _aten.arange.default,
      _aten.arange.start, _aten.arange.start_step, _aten.zeros.default,
      _aten.ones.default)
def _creation(c):
    """A creation op of constant arguments: its value, as an
    initializer."""
    fn = c.node.target
    kwargs = dict(c.node.kwargs)
    kwargs["device"] = "cpu"
    value = fn(*c.node.args, **kwargs)
    return c.g.node("Identity", [c.g.const(value, value.dtype, "value")])


# --- the walker ------------------------------------------------------------


def _translate(gm, input_names, g):
    """Walk the core-aten graph of GraphModule ``gm``, emitting nodes;
    returns the output names and their metas."""
    env = {}
    user = iter(input_names)
    outputs = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(user)
        elif node.op == "get_attr":      # a tensor the forward made
            t = getattr(gm, node.target)
            env[node] = g.const(t, t.dtype, "const")
        elif node.op == "call_function":
            target = node.target
            if target is operator.getitem:
                got = env[node.args[0]][node.args[1]]
                if got is None:
                    raise _unsupported(node.args[0].target,
                                       f"output {node.args[1]}")
                env[node] = got
                continue
            ns = getattr(target, "namespace", "")
            if ns == "mxnet_tpu_torch":
                raise NotImplementedError(
                    f"ONNX export: no translator for the hand-written "
                    f"kernel op '{_op_name(target)}' (a fused kernel has "
                    f"no ONNX form; export the block with fused=False or "
                    f"attention_impl='dense')")
            handler = _HANDLERS.get(target)
            if handler is None:
                raise _unsupported(target)
            env[node] = handler(_Ctx(g, node, env))
        elif node.op == "output":
            outs = node.args[0]
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            outputs = [(env[o], _val(o)) for o in outs]
    return outputs


# --- public API ------------------------------------------------------------


def _tuple_out(fn):
    def call(*args):
        out = fn(*args)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)
    return call


def _as_tensor(x):
    from ..ndarray.ndarray import NDArray, tensor_from_numpy
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return tensor_from_numpy(np.asarray(x))


def _program(fn, args):
    """The core-aten graph of ``fn(*args)``: traced on fake tensors with
    the core decomposition table (``make_fx``; ``torch.export`` runs the
    same forward through its bytecode tracer, ~50x slower here)."""
    from torch._decomp import core_aten_decompositions
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.no_grad():       # inference: no grad-mode switch recorded
        gm = make_fx(fn, decomposition_table=core_aten_decompositions(),
                     tracing_mode="fake")(*args)
    gm.graph.eliminate_dead_code()      # e.g. max pooling's unused indices
    return gm


def export_function(fn, example_args, path, input_names=None,
                    param_arrays=None, param_names=None,
                    model_name="mxnet_tpu"):
    """Export ``fn(params, *inputs)`` (or ``fn(*inputs)`` when
    ``param_arrays`` is None), a function on torch tensors, to an ONNX
    file at ``path``; the parameters become initializers."""
    example = tuple(_as_tensor(x) for x in example_args)
    if param_arrays is not None:
        params = [_as_tensor(p) for p in param_arrays]
        program = _program(_tuple_out(lambda ps, *xs: fn(list(ps), *xs)),
                           (params, *example))
    else:
        params = []
        program = _program(_tuple_out(fn), example)
    return _write(program, params, example, path, input_names, param_names,
                  model_name)


def _write(program, params, example, path, input_names, param_names,
           model_name):
    g = _Graph()
    if input_names is None:
        input_names = [f"data{i}" if i else "data"
                       for i in range(len(example))]
    names = []
    for i, p in enumerate(params):
        pname = param_names[i] if param_names is not None else f"param_{i}"
        g.inits.append(_tensor(pname, p))
        names.append(pname)
    inputs_vi = [_value_info(n, x.shape, x.dtype)
                 for n, x in zip(input_names, example)]
    outs = _translate(program, names + list(input_names), g)
    outputs_vi = []
    for i, (oname, meta) in enumerate(outs):
        pub = f"output{i}" if i else "output"
        g.node("Identity", [oname], outputs=[pub])
        outputs_vi.append(_value_info(pub, meta.shape, meta.dtype))
    graph = (b"".join(proto.field_bytes(1, n) for n in g.nodes)
             + proto.field_str(2, model_name)
             + b"".join(proto.field_bytes(5, t) for t in g.inits)
             + b"".join(proto.field_bytes(11, v) for v in inputs_vi)
             + b"".join(proto.field_bytes(12, v) for v in outputs_vi))
    opset = proto.field_str(1, "") + proto.field_varint(2, 13)
    model = (proto.field_varint(1, 8)              # ir_version 8
             + proto.field_str(2, "mxnet_tpu_torch")
             + proto.field_str(3, "0.1")
             + proto.field_bytes(7, graph)
             + proto.field_bytes(8, opset))
    with open(path, "wb") as f:
        f.write(model)
    return path


def export_model(net, example_args, path, model_name=None, epoch=0):
    """Export a (Hybrid)Block's inference forward to ONNX (ref:
    mx.onnx.export_model).  ``example_args`` (NDArrays, tensors or numpy
    arrays) fix the input shapes and device; the block runs once on them
    (inference mode) to finish deferred initialisation, then is traced.
    The parameters are written under their ``collect_params`` names."""
    from .. import autograd
    from ..gluon.block import _flatten, _Serve
    from ..parallel.functional import param_names_and_values

    if not isinstance(example_args, (tuple, list)):
        example_args = (example_args,)
    example = tuple(_as_tensor(x) for x in example_args)
    with autograd.pause():
        net(*example)
    names, plist, arrays = param_names_and_values(net)
    leaves, spec = _flatten(example)
    params = [a.detach() for a in arrays]
    program = _program(_Serve(net, plist, spec), (params, *leaves))
    return _write(program, params, leaves, path, None, list(names),
                  model_name or type(net).__name__)
