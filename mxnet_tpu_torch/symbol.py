"""Symbolic graph frontend, ``mx.sym`` (the port of
``mxnet_tpu/symbol.py``).

A Symbol is a light Python DAG node, as in the JAX package.  ``bind``
makes an ``Executor`` (``executor.py``) that walks the DAG over the
registry's ops (``ops.registry.OPS``) on the bound tensors; on the card
it captures that walk, and its backward, as CUDA graphs (the JAX
package's ``jax.jit``).  Shape inference traces the same walk on
``meta`` tensors, which hold no data and run nothing (the JAX package's
``jax.eval_shape``), plus the classic parameter-shape rules
(weight/bias from ``num_hidden`` etc.), so ``simple_bind`` and
``infer_shape`` work from data shapes alone.

Surface: ``Variable``/``var``, a builder for every registry op
(auto-creating weight/bias/gamma/... inputs with MXNet's naming),
arithmetic sugar, ``Group``, multi-output indexing, ``list_arguments``/
``list_outputs``/``list_auxiliary_states``, ``infer_shape``, ``eval``,
``bind``, ``simple_bind`` and ``tojson``/``save``/``load``.  The json is
the JAX package's byte for byte (its marker ``"attrs": {"mxnet_tpu":
"1"}`` included), so either package loads the other's file.
"""
from __future__ import annotations

import ast
import functools
import json
import re
import sys
from typing import Dict, List, Optional

import torch

from .context import shape_trace
from .ops.registry import OPS, OP_META, register_op, get_op

# ---------------------------------------------------------------------------
# layer-parameter table: which op inputs are learnable params / aux states,
# and how their shapes follow from the data shape + attrs (ref: each op's
# InferShape in src/operator/nn/*-inl.h).  Ops not listed take ONLY explicit
# Symbol inputs (positional or by keyword).
# ---------------------------------------------------------------------------


def _prod(xs):
    p = 1
    for x in xs:
        p *= int(x)
    return p


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _fc_shapes(d, a):
    k = _prod(d[1:]) if a.get("flatten", True) else int(d[-1])
    n = int(a["num_hidden"])
    return {"weight": (n, k), "bias": (n,)}


def _conv_shapes(d, a):
    nd = len(d) - 2
    kernel = _tup(a.get("kernel"), nd)
    nf, ng = int(a["num_filter"]), int(a.get("num_group", 1))
    if (a.get("layout") or "NCHW").endswith("C"):  # NHWC / NDHWC
        w = (nf,) + kernel + (int(d[-1]) // ng,)
    else:
        w = (nf, int(d[1]) // ng) + kernel
    return {"weight": w, "bias": (nf,)}


def _deconv_shapes(d, a):
    nd = len(d) - 2
    kernel = _tup(a.get("kernel"), nd)
    nf, ng = int(a["num_filter"]), int(a.get("num_group", 1))
    return {"weight": (int(d[1]), nf // ng) + kernel, "bias": (nf,)}


def _bn_shapes(d, a):
    c = int(d[int(a.get("axis", 1)) % len(d)])
    return {k: (c,) for k in ("gamma", "beta", "moving_mean", "moving_var")}


def _embed_shapes(d, a):
    return {"weight": (int(a["input_dim"]), int(a["output_dim"]))}


class _LayerSpec:
    def __init__(self, data, params=(), aux=(), labels=(), shapes=None,
                 skip=None):
        self.data = tuple(data)        # ordinary symbol inputs, in op order
        self.params = tuple(params)    # auto-created learnable inputs
        self.aux = tuple(aux)          # auto-created non-learnable state
        self.labels = tuple(labels)    # auto-created label inputs
        self.shapes = shapes           # fn(data_shape, attrs) -> {param: shape}
        self.skip = skip or {}         # param -> fn(attrs) -> bool (omit)

    def inputs(self, attrs):
        out = list(self.data)
        for p in self.params:
            if not (p in self.skip and self.skip[p](attrs)):
                out.append(p)
        out.extend(self.aux)
        out.extend(self.labels)
        return out


_no_bias = {"bias": lambda a: bool(a.get("no_bias", False))}

LAYERS: Dict[str, _LayerSpec] = {
    "FullyConnected": _LayerSpec(["data"], ["weight", "bias"],
                                 shapes=_fc_shapes, skip=_no_bias),
    "Convolution": _LayerSpec(["data"], ["weight", "bias"],
                              shapes=_conv_shapes, skip=_no_bias),
    "Deconvolution": _LayerSpec(["data"], ["weight", "bias"],
                                shapes=_deconv_shapes, skip=_no_bias),
    "BatchNorm": _LayerSpec(["data"], ["gamma", "beta"],
                            aux=["moving_mean", "moving_var"],
                            shapes=_bn_shapes),
    "Embedding": _LayerSpec(["data"], ["weight"], shapes=_embed_shapes),
    "SoftmaxOutput": _LayerSpec(["data"], labels=["label"]),
    "LinearRegressionOutput": _LayerSpec(["data"], labels=["label"]),
    "MAERegressionOutput": _LayerSpec(["data"], labels=["label"]),
    "LogisticRegressionOutput": _LayerSpec(["data"], labels=["label"]),
    "make_loss": _LayerSpec(["data"]),
}
LAYERS["MakeLoss"] = LAYERS["make_loss"]

# ops whose registry function returns (out, new_moving_mean, new_moving_var)
# — the functional aux-state form (see ops/nn.py _batch_norm docstring)
_AUX_STATE_OPS = {"BatchNorm": ("moving_mean", "moving_var")}


# ---------------------------------------------------------------------------
# static output arity.  ``_Node.n_out`` used to be discovered as a side
# effect of tracing (walk_graph measured the result tuple), which made
# ``list_outputs``/``tojson`` non-deterministic: a fresh or json-loaded
# multi-output symbol reported one output until the first eval.  The arity
# of every multi-output op is a pure function of its attrs (the reference
# computes it the same way — each op's ListOutputNames), so compute it from
# this table; ops without a rule get a ONE-TIME probe on ``meta`` tensors
# (cached per (op, attrs, arity); meta tensors run nothing) and fall back
# to 1 when the op cannot run on placeholder shapes.
# ---------------------------------------------------------------------------

def _n_out_split(a):
    return int(a.get("num_outputs", 1))


def _n_out_split_v2(a):
    if a.get("sections"):
        return int(a["sections"])
    return len(tuple(a.get("indices", ()))) + 1


def _n_out_mean_var(a):
    return 3 if a.get("output_mean_var", False) else 1


_N_OUT_RULES = {
    "split": _n_out_split, "SliceChannel": _n_out_split,
    "split_v2": _n_out_split_v2,
    "topk": lambda a: 2 if a.get("ret_typ") == "both" else 1,
    "RNN": lambda a: 3 if a.get("mode", "lstm") == "lstm" else 2,
    "BatchNorm": _n_out_mean_var,
    "LayerNorm": _n_out_mean_var, "layer_norm": _n_out_mean_var,
    "FusedNormReluConv": lambda a: 3, "fused_norm_relu_conv": lambda a: 3,
    "MultiBoxTarget": lambda a: 3, "multibox_target": lambda a: 3,
    "_contrib_MultiBoxTarget": lambda a: 3,
    "Proposal": lambda a: 2 if a.get("output_score", False) else 1,
    "proposal": lambda a: 2 if a.get("output_score", False) else 1,
    "_contrib_Proposal": lambda a: 2 if a.get("output_score", False) else 1,
    "quantize_v2": lambda a: 3,
    "_sample_multinomial": lambda a: 2 if a.get("get_prob", False) else 1,
    "sample_multinomial": lambda a: 2 if a.get("get_prob", False) else 1,
}

_N_OUT_PROBED: Dict[tuple, int] = {}


def _probe_key(op: str, attrs: dict, n_inputs: int) -> tuple:
    return (op, tuple(sorted((k, str(v)) for k, v in attrs.items()
                             if not k.startswith("__"))), n_inputs)


def _probe_n_out(op: str, attrs: dict, n_inputs: int) -> int:
    """Run an unruled op on ``meta`` placeholder inputs to count its
    outputs — once per (op, attrs, arity); unprobeable ops (shape-
    incompatible placeholders, missing required attrs) default to 1."""
    key = _probe_key(op, attrs, n_inputs)
    if key not in _N_OUT_PROBED:
        n = 1
        fn = OPS.get(op)
        if fn is not None:
            kwargs = {k: v for k, v in attrs.items()
                      if not k.startswith("__")}
            if OP_META.get(op, {}).get("has_training"):
                kwargs.setdefault("training", False)
            for shape in ((2, 8, 4, 4), (2, 8), (8,)):
                args = [torch.empty(shape, device="meta")] * n_inputs
                try:
                    with shape_trace(), torch.no_grad():
                        res = fn(*args, **kwargs)
                except Exception:
                    continue
                n = len(res) if isinstance(res, tuple) else 1
                break
        _N_OUT_PROBED[key] = n
    return _N_OUT_PROBED[key]


def _static_n_out(node) -> int:
    if node.op is None:
        return 1
    rule = _N_OUT_RULES.get(node.op)
    if rule is not None:
        n = int(rule(node.attrs))
    else:
        n = _probe_n_out(node.op, node.attrs, len(node.inputs))
    if n > 1 and node_threads_aux(node):
        n = 1  # trailing outputs thread back into aux state, not heads
    # NB: not ``max(1, n)`` — this module's namespace is op-builder
    # territory (sym.max shadows the builtin after generation)
    return n if n > 1 else 1


def observe_n_out(node, observed: int):
    """Executor callback when a trace yields a tuple of ``observed``
    outputs.  For ops with a static rule a mismatch is a BUG in
    ``_N_OUT_RULES`` and raises.  For probe-fallback ops (a custom
    ``register_op`` the placeholder probe could not abstractly evaluate,
    which defaults to 1) the observed arity wins: the node and the probe
    cache reconcile, so the op keeps working — at the documented cost
    that ``list_outputs`` on such an op reads 1 until its first eval."""
    if observed == node.n_out:
        return
    if node.op in _N_OUT_RULES:
        raise RuntimeError(
            f"op {node.op!r}: traced output arity {observed} != static "
            f"rule value {node.n_out}; fix symbol._N_OUT_RULES")
    _N_OUT_PROBED[_probe_key(node.op, node.attrs,
                             len(node.inputs))] = observed
    node._n_out = observed


def node_threads_aux(node) -> bool:
    """True when this node's trailing outputs are aux-state updates to
    thread back (NOT when BatchNorm's output_mean_var=True turns them into
    user-visible (out, mean, inv_std) heads — ops/nn.py _batch_norm)."""
    return node.op in _AUX_STATE_OPS and \
        not node.attrs.get("output_mean_var", False)


def data_variables(sym: "Symbol"):
    """The variables a USER must feed, in graph order: everything that is
    neither an auto-creatable layer param/aux nor a loss-head label."""
    labeled = label_variables(sym)
    param_slots = set()
    for n in sym._topo_nodes():
        spec = LAYERS.get(n.op or "")
        if spec:
            slots = spec.inputs(n.attrs)
            for slot, s in zip(slots, n.inputs):
                if slot not in spec.data and s._node.op is None:
                    param_slots.add(s._node.name)
    return [n.name for n in sym._topo_nodes()
            if n.op is None and n.name not in labeled
            and n.name not in param_slots]


# ---------------------------------------------------------------------------
# the Symbol DAG
# ---------------------------------------------------------------------------

def _scoped_name(name, op: str) -> str:
    """Node name via the active mx.name scope (ref: NameManager.get —
    `with mx.name.Prefix('net_'):` prefixes BOTH auto-generated and
    explicit op names, so two towers built under different prefixes never
    collide)."""
    from . import name as _name

    base = re.sub(r"[^0-9a-zA-Z]", "", op).lower()
    return _name.current().get(name, base)


def _auto_name(op: str) -> str:
    return _scoped_name(None, op)


def reset_auto_names():
    """Test helper: deterministic auto-naming per test."""
    from . import name as _name

    _name.current()._counts.clear()


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "_n_out")

    def __init__(self, op: Optional[str], name: str, attrs=None, inputs=(),
                 is_aux=False):
        self.op = op               # None => variable ('null' in json)
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)  # list[Symbol]
        self.is_aux = is_aux
        self._n_out = None

    @property
    def n_out(self) -> int:
        """Output arity, fixed by (op, attrs) at construction — NOT a
        tracing side effect, so list_outputs/tojson agree on fresh and
        loaded symbols.  Resolved lazily (first read) only so plain
        single-output graph building never pays the probe for exotic
        ops; the value itself is deterministic."""
        if self._n_out is None:
            self._n_out = _static_n_out(self)
        return self._n_out


class Symbol:
    """One output of a graph node (ref: python/mxnet/symbol/symbol.py).

    ``whole=True`` marks the undissected result of a builder call: for
    multi-output ops (SliceChannel, topk both, ...) a whole symbol stands
    for EVERY output (bind/forward returns them all, like the reference),
    while ``sym[i]`` selects one."""

    def __init__(self, node: _Node, index: int = 0, group=None, whole=False):
        self._node = node
        self._index = index
        self._whole = whole
        self._group: Optional[List[Symbol]] = group  # Group() members

    # ---- identity ----
    @property
    def name(self):
        return "_group" if self._group is not None else self._node.name

    def attr(self, key):
        if self._group is not None:
            return None
        meta = self._node.attrs.get("__meta__") or {}
        if key in meta:
            return meta[key]
        return self._node.attrs.get(key)

    def list_attr(self):
        if self._group is not None:
            return {}
        out = {k: v for k, v in self._node.attrs.items()
               if not k.startswith("__")}
        out.update(self._node.attrs.get("__meta__") or {})
        return out

    def __repr__(self):
        return f"<Symbol {self.name}>"

    # ---- graph walks ----
    def _outputs_list(self) -> List["Symbol"]:
        return list(self._group) if self._group is not None else [self]

    def _topo_nodes(self) -> List[_Node]:
        seen, order = set(), []

        def walk(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for s in node.inputs:
                walk(s._node)
            order.append(node)

        for s in self._outputs_list():
            walk(s._node)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo_nodes()
                if n.op is None and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo_nodes() if n.op is None and n.is_aux]

    def list_outputs(self):
        outs = []
        for s in self._outputs_list():
            n = s._node
            if n.n_out > 1 and s._whole:
                outs.extend(f"{n.name}_output{i}" for i in range(n.n_out))
            elif n.n_out > 1:
                outs.append(f"{n.name}_output{s._index}")
            else:
                outs.append(f"{n.name}_output")
        return outs

    def get_internals(self):
        return Group([Symbol(n) for n in self._topo_nodes() if n.op is not None]
                     or [self])

    def __getitem__(self, i):
        if self._group is not None:
            return self._group[i]
        return Symbol(self._node, i, whole=False)

    # ---- composition sugar ----
    def _binop(self, other, op, swap=False):
        if not isinstance(other, Symbol):
            other = _scalar_const(other)
        a, b = (other, self) if swap else (self, other)
        return _invoke_sym(op, [a, b], {}, None)

    def __add__(self, o):
        return self._binop(o, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", swap=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", swap=True)

    def __neg__(self):
        return _invoke_sym("negative", [self], {}, None)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power")

    # ---- evaluation / binding (executor.py implements the machinery) ----
    def eval(self, ctx=None, **bindings):
        from .executor import eval_symbol

        return eval_symbol(self, ctx, bindings)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, capture=None):
        """An ``Executor`` over the given arrays; ``capture=False`` runs
        its programs eagerly on the card (``executor``'s doc)."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        capture=capture)

    def simple_bind(self, ctx=None, grad_req="write", capture=None,
                    **shapes):
        from .executor import simple_bind

        return simple_bind(self, ctx, grad_req, shapes, capture=capture)

    # ---- shape inference ----
    def infer_shape(self, **kwargs):
        """ref: MXSymbolInferShape.  kwargs: data/label shapes.  Parameter
        shapes come from the LAYERS rules, output shapes from the same
        walk of the graph on meta tensors (``infer_arg_shapes``)."""
        arg_shapes, outs = _infer(self, kwargs)
        return ([tuple(arg_shapes[a]) for a in self.list_arguments()],
                [tuple(o.shape) for o in outs],
                [tuple(arg_shapes[a]) for a in self.list_auxiliary_states()])

    # ---- serialization (MXNet-1.x style node-list json) ----
    def tojson(self):
        nodes_list = self._topo_nodes()
        idx = {id(n): i for i, n in enumerate(nodes_list)}
        nodes = []
        for n in nodes_list:
            nodes.append({
                "op": "null" if n.op is None else n.op,
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()} | (
                    {"__is_aux__": "1"} if n.is_aux else {}),
                "inputs": [[idx[id(s._node)], s._index, 0]
                           for s in n.inputs],
            })
        # one heads entry PER OUTPUT: a whole multi-output head
        # (SliceChannel, BatchNorm output_mean_var, RNN state heads)
        # contributes every output index, so fromjson(tojson()) keeps
        # outputs 1+ instead of silently collapsing to output 0
        heads = []
        for s in self._outputs_list():
            n = s._node.n_out
            if s._whole and n > 1:
                heads.extend([idx[id(s._node)], i, 0] for i in range(n))
            else:
                heads.append([idx[id(s._node)], s._index, 0])
        return json.dumps({"nodes": nodes,
                           "arg_nodes": [i for i, n in enumerate(nodes_list)
                                         if n.op is None],
                           "heads": heads,
                           "attrs": {"mxnet_tpu": "1"}}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _scalar_const(v):
    """Scalar constant as a variable-free graph node (full op)."""
    return _invoke_sym("_scalar", [], {"value": float(v)}, None)


if "_scalar" not in OPS:
    @register_op("_scalar")
    def _scalar(value=0.0):
        """Symbol-frontend scalar literal (sugar for `sym + 2`): a 0-d
        float32 on the current context's device (the executor runs its
        graph under its own), made on the device by ``torch.full`` so a
        capture may hold it."""
        from .ops.elementwise import _device

        return torch.full((), float(value), dtype=torch.float32,
                          device=_device(None))


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, dtype=None, init=None,
             __is_aux__=False, **kwargs):
    """ref: mx.sym.Variable — the active AttrScope applies to variables
    too (explicit attr=/kwargs win over the scope)."""
    from .attribute import current_attrs

    attrs = current_attrs()
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = str(init)
    attrs.update(kwargs)
    return Symbol(_Node(None, name, attrs, (), is_aux=__is_aux__))


var = Variable


def Group(symbols):
    """ref: mx.sym.Group — multi-head symbol."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs_list())
    return Symbol(outs[0]._node, outs[0]._index, group=outs)


def _invoke_sym(op_name, sym_inputs, attrs, name):
    node = _Node(op_name, _scoped_name(name, op_name), attrs, sym_inputs)
    return Symbol(node, whole=True)


@functools.lru_cache(maxsize=4096)
def _signature_info_cached(fn):
    """(parameter names, has *args) — keyed on the registered function
    itself, so re-registering an op never serves a stale signature."""
    import inspect

    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return (), False
    return (tuple(params),
            any(p.kind is inspect.Parameter.VAR_POSITIONAL
                for p in params.values()))


def _signature_info(op_name):
    return _signature_info_cached(get_op(op_name))


def _signature_order(op_name):
    return list(_signature_info(op_name)[0])


def _signature_has_varargs(op_name):
    return _signature_info(op_name)[1]


def _make_builder(op_name):
    def builder(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_args = list(args)
        # keyword Symbol inputs -> ordered by the op signature
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol)}
        # 1.x attribute METADATA (lr_mult, ctx_group, ...) — the active
        # AttrScope stack first, then the per-call attr dict (inner wins);
        # kept on the node for Symbol.attr()/list_attr(), never forwarded
        # to the op
        from .attribute import current_attrs

        meta = current_attrs()
        if attr:
            meta.update(attr)
        if meta:
            attrs["__meta__"] = meta
        spec = LAYERS.get(op_name)
        if spec is not None:
            wanted = spec.inputs(attrs)
            inputs = []
            it = iter(sym_args)
            nm = _scoped_name(name, op_name)
            for slot in wanted:
                if slot in sym_kwargs:
                    inputs.append(sym_kwargs.pop(slot))
                    continue
                nxt = next(it, None)
                if nxt is not None:
                    inputs.append(nxt)
                    continue
                # auto-create with MXNet's naming convention; the MERGED
                # metadata (scope overridden by the call's attr=) goes on
                # the param variable so its attr() agrees with the layer's
                is_aux = slot in spec.aux
                inputs.append(Variable(f"{nm}_{slot}", __is_aux__=is_aux,
                                       attr=attrs.get("__meta__")))
            if sym_kwargs:
                raise TypeError(f"{op_name}: unexpected symbol kwargs "
                                f"{sorted(sym_kwargs)}")
            node = _Node(op_name, nm, attrs, inputs)
            return Symbol(node, whole=True)
        # generic op: non-Symbol positionals map onto the op signature as
        # attrs (sym.zeros((2,3)), sym.arange(2, 8) — the 1.x calling
        # convention for creation/scalar-leading ops); Symbol positionals
        # stay graph inputs, in order
        if any(not isinstance(a, Symbol) for a in sym_args):
            if _signature_has_varargs(op_name):
                raise TypeError(
                    f"{op_name}: takes a variable number of symbol inputs; "
                    f"pass scalar parameters as keywords")
            order = _signature_order(op_name)
            if len(sym_args) > len(order):
                raise TypeError(
                    f"{op_name}: takes at most {len(order)} positional "
                    f"arguments ({len(sym_args)} given)")
            mapped = []
            for pname, a in zip(order, sym_args):
                if isinstance(a, Symbol):
                    mapped.append(a)
                elif pname in attrs:
                    raise TypeError(
                        f"{op_name}: got multiple values for argument "
                        f"{pname!r}")
                else:
                    attrs[pname] = a
            sym_args = mapped
        # keyword symbols append in signature order
        if sym_kwargs:
            order = _signature_order(op_name)
            for pname in order:
                if pname in sym_kwargs:
                    sym_args.append(sym_kwargs.pop(pname))
            if sym_kwargs:
                raise TypeError(f"{op_name}: unknown symbol kwargs "
                                f"{sorted(sym_kwargs)}")
        return _invoke_sym(op_name, sym_args, attrs, name)

    builder.__name__ = op_name
    builder.__qualname__ = f"sym.{op_name}"
    builder.__doc__ = (get_op(op_name).__doc__ or "") + \
        "\n(symbolic builder)"
    return builder


# ---------------------------------------------------------------------------
# parameter shape inference (LAYERS rules + __shape__ hints)
# ---------------------------------------------------------------------------

def check_unique_variables(sym: Symbol):
    """Two DISTINCT variable nodes sharing one name would silently collapse
    into a single bound array (dict-keyed binding) — the reference raises a
    duplicate-argument error at bind; so do we (e.g. two same-prefix
    LSTMCells both creating 'lstm_i2h_weight')."""
    seen: Dict[str, object] = {}
    for n in sym._topo_nodes():
        if n.op is None:
            if n.name in seen and seen[n.name] is not n:
                raise ValueError(
                    f"duplicate variable name {n.name!r}: two distinct "
                    f"graph variables share it (same-prefix cells/layers?) "
                    f"— give them unique names/prefixes")
            seen[n.name] = n


_UNKNOWN = object()     # a value whose shape is not known yet


def _param_suffix(layer, var):
    """The slot of a layer's parameter variable: auto-created params are
    f"{layer}_{slot}" (multi-word slots like moving_mean); explicitly
    passed ones fall back to the trailing component."""
    if var.startswith(layer + "_"):
        return var[len(layer) + 1:]
    return var.rsplit("_", 1)[-1]


def _label_shape(node, dshape):
    """ref: softmax_output-inl.h label shape — one class id per sample;
    with multi_output=True softmax runs over axis 1 and the label carries
    the REMAINING spatial axes (d[0], d[2:]).  Regression heads take the
    data's shape."""
    if node.op == "SoftmaxOutput":
        if node.attrs.get("multi_output", False):
            return (int(dshape[0]),) + tuple(int(x) for x in dshape[2:])
        return (int(dshape[0]),)
    return tuple(dshape)


def infer_arg_shapes(sym: Symbol, known: Dict[str, tuple]) -> Dict[str, tuple]:
    """Shapes for every argument+aux variable: caller-provided data/label
    shapes, variable __shape__ hints, and the per-layer weight rules."""
    return _infer(sym, known)[0]


def _infer(sym: Symbol, known: Dict[str, tuple]):
    """``infer_arg_shapes``' shapes and the outputs as meta tensors.

    One walk of the graph on meta tensors (``context.shape_trace``), in
    topo order: at each layer its data input's value is already walked,
    so the layer's rules size its parameters before the layer itself is
    applied, and a loss head sizes its label from its data input.  (The
    JAX package walks the prefix below every layer again, which on a
    ResNet-50 symbol costs seconds on meta tensors; a layer whose data
    could not be walked in order falls back to that prefix walk.)"""
    from .executor import abstract_eval_prefix, walk_graph

    check_unique_variables(sym)

    shapes: Dict[str, tuple] = {}
    for n in sym._topo_nodes():
        if n.op is None:
            if n.name in known:
                shapes[n.name] = tuple(known[n.name])
            elif "__shape__" in n.attrs:
                shapes[n.name] = tuple(n.attrs["__shape__"])

    def meta(name):
        return torch.empty(shapes[name], dtype=torch.float32, device="meta")

    def leaf(node):
        return meta(node.name) if node.name in shapes else _UNKNOWN

    def apply_op(node, ins, attrs):
        spec = LAYERS.get(node.op)
        if spec is not None and (spec.shapes or spec.labels):
            data = ins[0]
            if data is _UNKNOWN:
                dshape = abstract_eval_prefix(node.inputs[0], shapes)
                if dshape is None and spec.shapes:
                    raise ValueError(
                        f"infer_shape: cannot determine input shape of "
                        f"layer {node.name!r}; provide the shape of its "
                        f"data variable")
            else:
                dshape = tuple(data.shape)
            if dshape is not None:
                rules = spec.shapes(dshape, node.attrs) if spec.shapes \
                    else {}
                slots = spec.inputs(node.attrs)
                for slot, s in zip(slots, node.inputs):
                    var = s._node
                    if var.op is not None or var.name in shapes:
                        continue
                    suffix = _param_suffix(node.name, var.name)
                    if suffix in rules:
                        shapes[var.name] = tuple(rules[suffix])
                    elif slot in spec.labels:
                        shapes[var.name] = _label_shape(node, dshape)
        ins = [meta(s._node.name) if v is _UNKNOWN and s._node.op is None
               and s._node.name in shapes else v
               for v, s in zip(ins, node.inputs)]
        if any(v is _UNKNOWN for v in ins):
            return _UNKNOWN
        if OP_META.get(node.op, {}).get("has_training"):
            attrs.setdefault("training", False)
        return get_op(node.op)(*ins, **attrs)

    with shape_trace(), torch.no_grad():
        outs = walk_graph(sym, leaf, apply_op, lambda name, value: None)
    missing = [n.name for n in sym._topo_nodes()
               if n.op is None and n.name not in shapes]
    if missing:
        raise ValueError(f"infer_shape: missing shapes for {missing}; "
                         f"pass them as infer_shape(name=shape, ...)")
    return shapes, outs


# ---------------------------------------------------------------------------
# load (json) + module namespace generation
# ---------------------------------------------------------------------------

def label_variables(sym: Symbol):
    """Names of variables bound to loss-head LABEL slots (SoftmaxOutput
    etc.) — graph inputs, not weights; SymbolBlock feeds zeros for them at
    inference (the reference's output ops ignore labels in forward)."""
    out = set()
    for n in sym._topo_nodes():
        spec = LAYERS.get(n.op or "")
        if spec and spec.labels:
            slots = spec.inputs(n.attrs)
            for slot, s in zip(slots, n.inputs):
                if slot in spec.labels and s._node.op is None:
                    out.add(s._node.name)
    return out


def _parse_attr(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def fromjson(text: str) -> Symbol:
    d = json.loads(text)
    built: List[Symbol] = []
    for nd_ in d["nodes"]:
        attrs = {k: _parse_attr(v) for k, v in (nd_.get("attrs") or {}).items()}
        is_aux = bool(attrs.pop("__is_aux__", 0))
        if nd_["op"] == "null":
            built.append(Variable(nd_["name"], __is_aux__=is_aux, **attrs))
        else:
            ins = [built[i][oi] for i, oi, _ in nd_["inputs"]]
            node = _Node(nd_["op"], nd_["name"], attrs, ins)
            built.append(Symbol(node))
    heads = [built[i][oi] for i, oi, _ in d["heads"]]
    if len(heads) == 1:
        return heads[0]
    # a multi-output head was serialized as one entry per output index —
    # rebuild a Group so list_outputs/bind see every output, like the
    # symbol that was saved
    return Group(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return fromjson(f.read())


_this = sys.modules[__name__]
for _n in list(OPS):
    if not hasattr(_this, _n):
        setattr(_this, _n, _make_builder(_n))

# sub-namespaces mirroring mx.nd's layout (ref: mx.sym.contrib / mx.sym.linalg
# / mx.sym.random in python/mxnet/symbol/) — same builders, shorter names
import types as _types  # noqa: E402

def _builder_for(op_name):
    """The generation loop above set a builder for EVERY registry name
    (including internal _contrib_/_random_ ones), so namespace population
    reuses those; the fallback only guards against a future module-level
    attribute shadowing an op name with a non-callable."""
    existing = getattr(_this, op_name, None)
    return existing if callable(existing) else _make_builder(op_name)


from .ops.registry import CONTRIB_SHORT_NAMES  # noqa: E402

contrib = _types.ModuleType(__name__ + ".contrib")
for _n in list(OPS):
    if _n.startswith("_contrib_"):
        setattr(contrib, _n[len("_contrib_"):], _builder_for(_n))
for _short in CONTRIB_SHORT_NAMES:
    if _short in OPS:
        setattr(contrib, _short, _builder_for(_short))
sys.modules[__name__ + ".contrib"] = contrib

linalg = _types.ModuleType(__name__ + ".linalg")
for _n in list(OPS):
    if _n.startswith("linalg_"):
        setattr(linalg, _n[len("linalg_"):], _builder_for(_n))
sys.modules[__name__ + ".linalg"] = linalg

random = _types.ModuleType(__name__ + ".random")
for _n in list(OPS):
    if _n.startswith("_random_"):
        setattr(random, _n[len("_random_"):], _builder_for(_n))
sys.modules[__name__ + ".random"] = random
