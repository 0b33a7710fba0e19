"""Symbolic executor (the port of ``mxnet_tpu/executor.py``).

The Symbol DAG is walked over the registry's ops on the bound tensors
(``walk_graph``, shared with ``gluon.SymbolBlock``).  MXNet's output
ops (``SoftmaxOutput`` and friends) carry their loss gradient
implicitly: their losses live in ``_HEAD_LOSSES``, and ``backward()``
takes the gradient of their sum (plus ``out_grads`` against the other
heads) by torch autograd, as the JAX executor takes ``jax.grad``.

On the card the executor's programs are captured CUDA graphs (the JAX
package's ``jax.jit``s), kept by the JAX executor's keys:

- ``forward(is_train=False)``: a forward graph (``graphs.GraphCache``)
  per signature of what is fed — the shape and dtype of every fed data
  and label array, as ``jax.jit`` keeps one executable per signature
  of the JAX executor's inputs;
- ``forward(is_train=True)`` then ``backward()``: a pair, the forward
  and, in its memory pool, the backward (``StepGraph(pool_of=...)``),
  keyed by the differentiated names and the heads given ``out_grads``.
  A key's first training forward and its backward run eagerly on the
  pair's capture stream; its next training forward captures both and
  replays the forward, and the backward replays the backward graph,
  which writes the gradients into ``grad_dict`` by ``grad_req``.  So
  the forward runs once a step and the gradient is taken under the
  dropout mask of the outputs the caller saw.  (The JAX executor traces
  the forward again inside ``jax.grad`` under a second key, so its
  gradient comes from another mask.)  A ``backward()`` with no training
  forward before it, or with other heads given ``out_grads`` than the
  pair was captured for, runs the forward again eagerly, with the
  running statistics left as they are, as in the JAX package.

Graphs read the bound tensors where they lie, so every write into a
bound array is in place: fed data (``forward(**feeds)``), gradients,
the running statistics a training forward updates, and what ``Module``
writes (``init_params``, ``set_params``, the optimizer's updates).  A
fed name keeps one array per shape and dtype it was fed at (the bound
array for the bound ones): a feed is copied into the array of its
signature, which is then bound, so switching between signatures (a
server's bucket grid) rebinds nothing a graph reads and drops no
graph.  A parameter, auxiliary or gradient array the caller rebinds
(``ex.arg_dict[n] = other``, or a new tensor under an array) is seen at
the next call, by identity, and every graph is made again; a fed
name's array rebound by the caller drops the graphs that read the old
one.  ``capture=False`` runs the same bodies eagerly (the
yardstick); on the CPU they always run eagerly and ``capture=True``
raises.

Shape inference (``abstract_eval``, ``abstract_eval_prefix``) walks the
graph on ``meta`` tensors inside ``context.shape_trace()``, all float32
as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .context import Context, context_of, resolve_device, shape_trace
from .graphs import GraphCache, StepGraph
from .ndarray.ndarray import NDArray, as_tensor
from .ops.registry import OP_META, get_op
from .symbol import (LAYERS, Symbol, check_unique_variables,
                     infer_arg_shapes, node_threads_aux, observe_n_out)

__all__ = ["Executor", "walk_graph", "simple_bind", "eval_symbol",
           "abstract_eval", "abstract_eval_prefix"]


# ---------------------------------------------------------------------------
# walking the DAG
# ---------------------------------------------------------------------------

def walk_graph(sym: Symbol, leaf, apply_op, aux_update):
    """The DAG-evaluation algorithm, shared by the executor (tensors,
    registry functions) and ``gluon.SymbolBlock`` (NDArrays,
    ``nd.invoke``).

    ``leaf(node) -> value`` resolves a variable; ``apply_op(node, ins,
    attrs) -> value|tuple`` applies one op; ``aux_update(name, value)``
    receives the functional aux-state outputs (BatchNorm moving stats)
    threading back into their variables.  A whole multi-output head
    yields EVERY output, like the reference's executor."""
    memo: Dict[int, object] = {}

    def value(s: Symbol):
        node = s._node
        key = id(node)
        if key not in memo:
            if node.op is None:
                memo[key] = leaf(node)
            else:
                ins = [value(i) for i in node.inputs]
                attrs = {k: v for k, v in node.attrs.items()
                         if not k.startswith("__")}
                res = apply_op(node, ins, attrs)
                if node_threads_aux(node) and isinstance(res, tuple):
                    out, new_aux = res[0], res[1:]
                    aux_syms = [i for i in node.inputs if i._node.is_aux]
                    for s_aux, v_new in zip(aux_syms, new_aux):
                        aux_update(s_aux._node.name, v_new)
                    res = out
                memo[key] = res
        res = memo[key]
        if isinstance(res, tuple):
            # arity is static (symbol._static_n_out): for ruled ops the
            # walk only CHECKS it; custom ops the probe could not run
            # reconcile to the walked arity
            observe_n_out(node, len(res))
            return res[s._index]
        return res

    outs = []
    try:
        for s in sym._outputs_list():
            first = value(s)
            res = memo[id(s._node)]
            if s._whole and isinstance(res, tuple):
                outs.extend(res)
            else:
                outs.append(first)
    finally:
        # ``value`` is a closure over itself and ``memo``: a reference
        # cycle, which would keep every intermediate (on the card, a
        # step's activations and autograd graph) until the cycle
        # collector ran; drop them now
        memo.clear()
    return outs


def _trace(sym: Symbol, arg_vals: Dict, aux_vals: Dict, training: bool):
    """Evaluate the DAG on tensors.  Returns (outputs, aux_updates)."""
    aux_updates: Dict[str, object] = {}

    def leaf(node):
        store = aux_vals if node.is_aux else arg_vals
        if node.name not in store:
            kind = "auxiliary state" if node.is_aux else "argument"
            raise ValueError(f"executor: unbound {kind} {node.name!r}")
        return store[node.name]

    def apply_op(node, ins, kwargs):
        if OP_META.get(node.op, {}).get("has_training"):
            kwargs.setdefault("training", training)
        return get_op(node.op)(*ins, **kwargs)

    outs = walk_graph(sym, leaf, apply_op, aux_updates.__setitem__)
    return outs, aux_updates


# ---------------------------------------------------------------------------
# implicit losses of the reference's output ops
# (ref: src/operator/softmax_output-inl.h Backward, regression_output-inl.h)
# ---------------------------------------------------------------------------

def _softmax_output_loss(out, label, attrs):
    axis = 1 if attrs.get("multi_output", False) else -1
    scale = float(attrs.get("grad_scale", 1.0))
    logp = torch.log(torch.clamp(out, min=1e-37))
    lab = label.to(torch.int64)
    # a negative label picks from the end, as jnp.take_along_axis does;
    # an ignored one is masked below
    idx = torch.remainder(lab, out.shape[axis]).unsqueeze(axis)
    picked = torch.gather(logp, axis % out.dim(), idx).squeeze(axis)
    valid = torch.ones_like(picked, dtype=torch.bool)
    if attrs.get("use_ignore", False):
        valid = lab != int(attrs.get("ignore_label", -1))
        picked = torch.where(valid, picked, torch.zeros_like(picked))
    norm = attrs.get("normalization", "null")
    total = -torch.sum(picked)
    if norm == "batch":
        total = total / out.shape[0]
    elif norm == "valid":
        total = total / torch.clamp(valid.sum(), min=1)
    return total * scale


def _linear_regression_loss(out, label, attrs):
    scale = float(attrs.get("grad_scale", 1.0))
    return 0.5 * torch.sum((out - label) ** 2) * scale


def _mae_regression_loss(out, label, attrs):
    scale = float(attrs.get("grad_scale", 1.0))
    return torch.sum(torch.abs(out - label)) * scale


def _logistic_regression_loss(out, label, attrs):
    # BCE on the sigmoid OUTPUT: d/dz = sigmoid(z) - label, the reference's
    # gradient (regression_output-inl.h LogisticRegressionOutput)
    scale = float(attrs.get("grad_scale", 1.0))
    p = torch.clamp(out, 1e-7, 1.0 - 1e-7)
    return -torch.sum(label * torch.log(p)
                      + (1 - label) * torch.log(1 - p)) * scale


def _make_loss_loss(out, label, attrs):
    return torch.sum(out) * float(attrs.get("grad_scale", 1.0))


_HEAD_LOSSES = {
    "SoftmaxOutput": _softmax_output_loss,
    "LinearRegressionOutput": _linear_regression_loss,
    "MAERegressionOutput": _mae_regression_loss,
    "LogisticRegressionOutput": _logistic_regression_loss,
    "make_loss": _make_loss_loss,
    "MakeLoss": _make_loss_loss,
}


def _head_label_name(node) -> Optional[str]:
    """Slot-based (any variable name), like symbol.label_variables."""
    spec = LAYERS.get(node.op or "")
    if spec and spec.labels:
        slots = spec.inputs(node.attrs)
        for slot, s in zip(slots, node.inputs):
            if slot in spec.labels and s._node.op is None:
                return s._node.name
    return None


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _as_nd(v, device):
    """``v`` as an NDArray on ``device``: an NDArray already there is
    kept (the caller's array is bound, not a copy of it)."""
    if isinstance(v, NDArray) and v._data.device == device:
        return v
    return NDArray(as_tensor(v, device=device))


def _to_context(ctx):
    if isinstance(ctx, Context):
        return ctx
    return context_of(resolve_device(ctx))


class _Pair:
    """A training key's graphs on the card: the forward and, sharing its
    memory pool, the backward, with their static tensors."""

    def __init__(self, device, reads):
        self.fwd = StepGraph(device)
        self.bwd = None
        self.warmed = False             # a backward ran eagerly
        self.reads = reads              # the fed tensors its bodies read

    @property
    def captured(self):
        return self.bwd is not None


class Executor:
    """ref: mx.executor.Executor — forward/backward over bound arrays.
    ``capture``: None captures on the card, False runs eagerly (see the
    module's doc)."""

    def __init__(self, symbol: Symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, capture=None):
        check_unique_variables(symbol)
        self._symbol = symbol
        self._ctx = _to_context(ctx)
        self._device = self._ctx.device
        if self._device.type != "cuda" and capture:
            raise ValueError(f"Executor(capture=True): a CUDA graph needs "
                             f"a CUDA device, got {self._device}; pass "
                             f"capture=None or False")
        self._capture = self._device.type == "cuda" and capture is not False
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()

        def normalize(vals, names, what):
            if vals is None:
                return {}
            if isinstance(vals, dict):
                return {k: _as_nd(v, self._device) for k, v in vals.items()}
            vals = list(vals)
            if len(vals) != len(names):
                raise ValueError(f"{what}: expected {len(names)} entries "
                                 f"({names}), got {len(vals)}")
            return {n: _as_nd(v, self._device) for n, v in zip(names, vals)}

        self.arg_dict: Dict[str, NDArray] = normalize(args, self._arg_names,
                                                      "args")
        self.aux_dict: Dict[str, NDArray] = normalize(aux_states,
                                                      self._aux_names, "aux")
        self.grad_dict: Dict[str, NDArray] = normalize(args_grad,
                                                       self._arg_names,
                                                       "args_grad")
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self._arg_names}
        self.outputs: List[NDArray] = []
        self._last_train = False
        self._forward_graphs = None     # GraphCache of inference forwards
        self._reads = {}                # its key -> the fed tensors read
        self._pairs = {}                # (diff names, out_grad keys) -> _Pair
        self._fed = {}                  # fed name -> {(shape, dtype): array}
        self._held = None               # the tensors the graphs read
        self._pending = None            # what a backward() may reuse
        self._last_og = ()              # out_grad keys of the last backward

    # ---- array-list views (reference API) ----
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def graph_count(self):
        """Captured programs held: one per inference signature, one per
        training pair (a forward and a backward graph)."""
        return len(self._forward_graphs or ()) + sum(
            p.captured for p in self._pairs.values())

    # ---- binding ----
    def _feed(self, name, value):
        """Copy a fed value into the array kept for its name, shape and
        dtype — the bound array where they match it, else one made at
        the first feed of that signature — and bind that array."""
        cur = self.arg_dict.get(name)
        if cur is value:
            return
        table = self._fed.get(name)
        if table is None:
            table = self._fed[name] = {}
            if cur is not None:
                table[(tuple(cur.shape), cur._data.dtype)] = cur
        t = value._data if isinstance(value, NDArray) else \
            value if isinstance(value, torch.Tensor) else as_tensor(value)
        key = (tuple(t.shape), t.dtype)
        arr = table.get(key)
        if arr is None:                 # never the caller's own storage
            arr = table[key] = NDArray(as_tensor(t, device=self._device))
        else:
            with torch.no_grad():
                arr._data.copy_(t)
        self.arg_dict[name] = arr

    def _fed_reads(self):
        """The tensors bound under the fed names, in name order."""
        return tuple(self.arg_dict[n]._data for n in sorted(self._fed))

    @staticmethod
    def _same(a, b):
        return len(a) == len(b) and all(x is y for x, y in zip(a, b))

    def _diff_names(self):
        return tuple(sorted(n for n, r in self._grad_req.items()
                            if r != "null"))

    def _check_held(self):
        """Drop the graphs when an array they read was rebound (every
        differentiated argument has its gradient array first)."""
        for n in self._diff_names():
            if n not in self.grad_dict:
                self.grad_dict[n] = NDArray(torch.zeros_like(
                    self.arg_dict[n]._data))
        held = tuple(d[n]._data if n in d else None
                     for d, names in ((self.arg_dict, self._arg_names),
                                      (self.aux_dict, self._aux_names),
                                      (self.grad_dict, self._arg_names))
                     for n in names if d is not self.arg_dict
                     or n not in self._fed)
        if self._held is None or not self._same(held, self._held):
            self._forward_graphs = None
            self._reads = {}
            self._pairs = {}
            self._pending = None
            self._held = held

    def _tensors(self):
        return ({n: a._data for n, a in self.arg_dict.items()},
                {n: a._data for n, a in self.aux_dict.items()})

    # ---- bodies ----
    def _infer_body(self):
        args, aux = self._tensors()
        with self._ctx, torch.no_grad():
            return tuple(_trace(self._symbol, args, aux, False)[0])

    def _train_body(self, write_aux=True):
        """The training forward with autograd on, over detached aliases
        of the differentiated arguments (the bound storage).  Returns
        (outputs, aliases by name)."""
        args, aux = self._tensors()
        leaves = {}
        for n in self._diff_names():
            leaves[n] = args[n] = args[n].detach().requires_grad_(True)
        with self._ctx, torch.enable_grad():
            outs, updates = _trace(self._symbol, args, aux, True)
        if write_aux:
            with torch.no_grad():
                for k, v in updates.items():
                    self.aux_dict[k]._data.copy_(v)
        return tuple(outs), leaves

    def _loss(self, outs, leaves, og):
        """The implicit losses of the heads plus ``out_grads`` against the
        others, summed in float32 (the JAX executor's loss).  A label
        being differentiated is read through its alias, as JAX reads
        its traced value."""
        total = torch.zeros((), dtype=torch.float32, device=self._device)
        pos = 0
        for h in self._symbol._outputs_list():
            n = h._node.n_out if (h._whole and h._node.n_out > 1) else 1
            for _ in range(n):
                out, i = outs[pos], pos
                pos += 1
                op = h._node.op
                if op in _HEAD_LOSSES and og.get(i) is None:
                    lname = _head_label_name(h._node)
                    lab = leaves.get(lname, self.arg_dict[lname]._data) \
                        if lname else None
                    total = total + _HEAD_LOSSES[op](
                        out, lab, h._node.attrs).float()
                elif og.get(i) is not None:
                    total = total + torch.sum(out.float() * og[i].float())
                # heads with neither an implicit loss nor a cotangent
                # contribute nothing (detached outputs)
        return total

    def _grad_body(self, outs, leaves, og):
        """The gradients of ``_loss`` written into ``grad_dict`` in place
        (``add`` accumulates)."""
        names = list(leaves)
        with self._ctx, torch.enable_grad():
            total = self._loss(outs, leaves, og)
        grads = [None] * len(names)
        if total.requires_grad and names:
            grads = torch.autograd.grad(total, [leaves[n] for n in names],
                                        allow_unused=True)
        with torch.no_grad():
            for n, g in zip(names, grads):
                dst = self.grad_dict[n]._data
                if g is None:
                    if self._grad_req[n] != "add":
                        dst.zero_()
                elif self._grad_req[n] == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)

    # ---- forward ----
    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            self._feed(k, v)
        self._pending = None
        self._check_held()
        if is_train:
            outs = self._train_forward()
        elif self._capture:
            outs = [o.clone() for o in self._infer_graphs()]
        else:
            outs = self._infer_body()
        self.outputs = [NDArray(o.detach()) for o in outs]
        self._last_train = bool(is_train)
        return self.outputs

    def _infer_graphs(self):
        """The inference forward through the graph of the fed signature
        (a graph whose fed tensors were rebound is made again)."""
        if self._forward_graphs is None:
            self._forward_graphs = GraphCache(self._device)
        key = tuple((n, tuple(self.arg_dict[n].shape),
                     self.arg_dict[n]._data.dtype)
                    for n in sorted(self._fed))
        reads = self._fed_reads()
        if not self._same(self._reads.get(key, reads), reads):
            self._forward_graphs.drop(key)
        self._reads[key] = reads
        return self._forward_graphs.run(key, self._infer_body)

    def _train_forward(self):
        if not self._capture:
            outs, leaves = self._train_body()
            self._pending = ("eager", outs, leaves, None)
            return outs
        key = (self._diff_names(), self._last_og)
        pair = self._pairs.get(key)
        reads = self._fed_reads()
        if pair is not None and not self._same(pair.reads, reads):
            pair = None                 # fed at another signature
        if pair is None or not pair.warmed:
            # a key's first training call runs eagerly on the capture
            # stream (its warm-up), as does its backward
            pair = pair or _Pair(self._device, reads)
            outs, leaves = self._on_capture_stream(pair, self._train_body)
            self._pending = ("eager", outs, leaves, pair)
            return outs
        if not pair.captured:
            self._capture_pair(pair, key[1])
        pair.fwd.replay()
        self._pending = ("replay", pair, key[1])
        return [o.clone() for o in pair.outs]

    @staticmethod
    def _on_capture_stream(pair, fn):
        out = pair.fwd.warm_up(fn)
        main = torch.cuda.current_stream(pair.fwd.device)
        for t in out[0]:               # made on the capture stream
            t.record_stream(main)
        return out

    def _capture_pair(self, pair, og_keys):
        """Capture a training key's forward, then its backward into the
        forward's pool (capturing runs nothing: no statistic moves)."""
        cts = {}
        outs, leaves = pair.fwd.capture(self._train_body)
        for i in og_keys:
            cts[i] = torch.zeros_like(outs[i])
        bwd = StepGraph(self._device, pool_of=pair.fwd)
        bwd.capture(lambda: self._grad_body(outs, leaves, cts))
        pair.outs = [o.detach() for o in outs]
        pair.cts = cts
        pair.bwd = bwd

    # ---- backward ----
    def backward(self, out_grads=None):
        """Fill grad arrays (ref: Executor::Backward).  For loss-op heads
        the implicit gradient is used; other heads need `out_grads`
        entries."""
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        og = {}
        heads = self._symbol._outputs_list()
        if out_grads is not None:
            for i, g in enumerate(out_grads):
                if g is not None:
                    og[i] = g._data if isinstance(g, NDArray) \
                        else as_tensor(g, device=self._device)
        else:
            missing = [h._node.op for h in heads
                       if h._node.op not in _HEAD_LOSSES]
            if missing:
                raise ValueError(
                    f"backward(): heads {missing} carry no implicit loss; "
                    f"pass out_grads")
        self._check_held()
        og_keys = tuple(sorted(og))
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == "replay" \
                and pending[2] == og_keys:
            pair = pending[1]
            with torch.no_grad():
                for i, buf in pair.cts.items():
                    buf.copy_(og[i])
            pair.bwd.replay()
            self._pending = pending     # the graph may be replayed again
        elif pending is not None and pending[0] == "eager":
            _, outs, leaves, pair = pending
            if pair is None:
                self._grad_body(outs, leaves, og)
            else:
                pair.fwd.warm_up(lambda: self._grad_body(outs, leaves, og))
                pair.warmed = True
                self._pairs[(self._diff_names(), og_keys)] = pair
        else:
            outs, leaves = self._train_body(write_aux=False)
            self._grad_body(outs, leaves, og)
        self._last_og = og_keys
        return self.grad_arrays


# ---------------------------------------------------------------------------
# binding helpers
# ---------------------------------------------------------------------------

def simple_bind(sym: Symbol, ctx, grad_req, shapes, capture=None):
    """ref: Symbol.simple_bind — infer every shape, allocate args/grads/aux
    (float32 zeros on ``ctx``)."""
    ctx = _to_context(ctx)
    arg_shapes = infer_arg_shapes(sym, shapes)

    def zeros(n):
        return NDArray(torch.zeros(arg_shapes[n], dtype=torch.float32,
                                   device=ctx.device))

    args, grads, aux = {}, {}, {}
    for n in sym.list_arguments():
        args[n] = zeros(n)
        req = grad_req.get(n, "null") if isinstance(grad_req, dict) \
            else grad_req
        if req != "null":
            grads[n] = zeros(n)
    for n in sym.list_auxiliary_states():
        aux[n] = zeros(n)
    return Executor(sym, ctx, args, grads, grad_req, aux, capture=capture)


def eval_symbol(sym: Symbol, ctx, bindings):
    """Symbol.eval — one-shot forward with everything bound by name (run
    eagerly: a one-shot program is not worth capturing)."""
    ex = Executor(sym, ctx, bindings, None, "null",
                  {n: bindings[n] for n in sym.list_auxiliary_states()
                   if n in bindings}, capture=False)
    return ex.forward(is_train=False)


def _meta(shape):
    return torch.empty(tuple(shape), dtype=torch.float32, device="meta")


def abstract_eval(sym: Symbol, arg_shapes: Dict[str, tuple]):
    """Output + aux shapes by a walk on meta tensors (the NNVM InferShape
    pass).  Returns (output meta tensors, aux shapes)."""
    argv = {n: _meta(arg_shapes[n]) for n in sym.list_arguments()}
    auxv = {n: _meta(arg_shapes[n]) for n in sym.list_auxiliary_states()}
    with shape_trace(), torch.no_grad():
        outs, _ = _trace(sym, argv, auxv, False)
    return outs, {n: tuple(arg_shapes[n]) for n in auxv}


def abstract_eval_prefix(s: Symbol, shapes: Dict[str, tuple]):
    """Shape of one intermediate symbol given variable shapes, or None when
    some variable below it has no known shape yet (infer_shape walks layers
    in topo order, so earlier layers' params are already inferred)."""
    nodes = s._topo_nodes()
    for n in nodes:
        if n.op is None and n.name not in shapes:
            return None
    argv = {n.name: _meta(shapes[n.name]) for n in nodes
            if n.op is None and not n.is_aux}
    auxv = {n.name: _meta(shapes[n.name]) for n in nodes
            if n.op is None and n.is_aux}
    with shape_trace(), torch.no_grad():
        outs, _ = _trace(s, argv, auxv, False)
    return tuple(outs[0].shape)
