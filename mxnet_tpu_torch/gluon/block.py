"""Gluon Block / HybridBlock as ``torch.nn.Module``s (the port of
``mxnet_tpu/gluon/block.py``).

A Block registers its child blocks as torch submodules and its
``Parameter``s in a prefix-scoped ``ParameterDict``: parameter names are
the JAX package's (``resnetv10_stage1_conv0_weight``), built by the same
name scopes.  ``collect_params``, ``initialize`` and ``cast`` walk the
tree.  A ``HybridBlock``'s ``forward`` gathers its own parameters'
tensors and calls ``hybrid_forward(F, x, *args, **params)`` with ``F``
the port's op namespace (``mxnet_tpu_torch.ops``); a parameter whose
shape is still a wildcard is sized by the layer's ``infer_shape`` at
the first forward.

Calling a block builds the autograd graph only inside
``autograd.record()``, as in the JAX package.  A block takes tensors or
NDArrays: NDArray inputs are unwrapped, and the outputs come back as
NDArrays only when NDArrays went in, so the training steps, the
captured graphs and the server keep passing tensors.  They come back as
``mx.np.ndarray`` when one went in or ``npx.set_np()`` holds, from an
eager and a hybridized block alike (the JAX package's hybridized
blocks return legacy NDArrays there: ROADMAP C12).

``save_parameters``/``load_parameters`` use structural names
(``0.weight``, ``features.3.body.1.gamma``) in ``nd.save``'s container,
so a file written by either package loads in the other;
``params_from_jax`` copies a JAX block's parameters in by full name.

``hybridize()`` makes every call of the outermost active block one
unit, the port of the JAX package's CachedOp: on the card, captured CUDA
graphs (``HybridBlock.hybridize`` says how); on the CPU, the same
bodies run without capture.

Hooks (``register_forward_hook``, ``register_forward_pre_hook``) fire on
eager calls, as in the JAX package; ``summary`` prints the JAX
package's table.

``SymbolBlock`` makes a block of an ``mx.sym`` graph (or of a callable
over ``nd`` arrays): the graph's remaining variables become its
parameters, and its forward walks the graph over the registry's ops.
``HybridBlock.export`` writes a block's inference forward as a
``torch.export`` program beside its parameters, and
``SymbolBlock.imports`` serves that pair without the block's class.
"""
from __future__ import annotations

import json
import os
import re
import threading
import weakref

import numpy as np
import torch

from .. import autograd as _autograd
from .. import numpy_extension as _npx
from .. import ops as _ops
from ..graphs import GraphCache, StepGraph
from ..ndarray.ndarray import NDArray, _wrap_all
from ..numpy import ndarray as _np_ndarray
from ..parallel.functional import functional_call, run_eagerly, \
    running_eagerly
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "params_from_jax"]

_naming = threading.local()


def _scope_stack():
    if not hasattr(_naming, "stack"):
        _naming.stack = [({}, "")]  # (per-scope counters, prefix so far)
    return _naming.stack


def _make_prefix(explicit, hint):
    """A block's prefix inside the enclosing name scope: ``explicit``,
    or ``hint`` plus the scope's running count of that hint."""
    counters, cur = _scope_stack()[-1]
    if explicit is not None:
        return cur + explicit
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{cur}{hint}{idx}_"


class _NameScope:
    def __init__(self, block):
        self._block = block

    def __enter__(self):
        _scope_stack().append((self._block._scope_counters,
                               self._block._prefix))
        return self

    def __exit__(self, *exc):
        _scope_stack().pop()


class _HookHandle:
    """A registered hook; ``detach()`` (or ``remove()``) unregisters it."""

    __slots__ = ("_hooks", "_hook")

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._hook = hook

    def detach(self):
        if self._hook is not None and self._hook in self._hooks:
            self._hooks.remove(self._hook)
        self._hook = None

    remove = detach


class Block(torch.nn.Module):
    """Base container: child blocks and prefix-scoped parameters."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = _make_prefix(prefix, self._alias())
        self._scope_counters = {}
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}
        self._gluon_hooks = []          # hook(block, args, out)
        self._gluon_pre_hooks = []      # hook(block, args)

    def _alias(self):
        return type(self).__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                self._params._params[value.name] = value
        super().__setattr__(name, value)

    @property
    def _children(self):
        return self._modules

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each eager call."""
        self._gluon_hooks.append(hook)
        return _HookHandle(self._gluon_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each eager call."""
        self._gluon_pre_hooks.append(hook)
        return _HookHandle(self._gluon_pre_hooks, hook)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return _NameScope(self)

    def collect_params(self, select=None):
        """This block's and its descendants' parameters (those whose
        names match the regular expression ``select``, if given)."""
        out = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None

        def _add(block):
            for name, p in block._params.items():
                if pattern is None or pattern.search(name):
                    out._params[name] = p
            for c in block._children.values():
                if c is not None:
                    _add(c)
        _add(self)
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx`` (None: the card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)
        return self

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        """Hybridize the child blocks (a plain Block runs eagerly)."""
        for c in self._children.values():
            if c is not None:
                c.hybridize(active, **kwargs)

    def __call__(self, *args):
        for hook in self._gluon_pre_hooks:
            hook(self, args)
        wrap = any(isinstance(a, NDArray) for a in args)
        targs = tuple(a._data if isinstance(a, NDArray) else a
                      for a in args) if wrap else args
        with torch.set_grad_enabled(_autograd.is_recording()):
            out = super().__call__(*targs)
        if wrap:
            out = _wrap_all(out, _out_class(args))
        for hook in self._gluon_hooks:
            hook(self, args, out)
        return out

    def summary(self, *inputs):
        """Print a table of the blocks (the JAX package's): with example
        ``inputs``, one forward (eager, not recording, even when
        hybridized) adds each block's output shape; without, the
        parameter counts only."""
        shapes = {}
        if inputs:
            handles = []

            def _capture(blk, _args, out):
                leaf = out[0] if isinstance(out, (tuple, list)) else out
                if hasattr(leaf, "shape"):
                    shapes[id(blk)] = tuple(leaf.shape)

            def _hook_all(b):
                handles.append(b.register_forward_hook(_capture))
                for c in b._children.values():
                    if c is not None:
                        _hook_all(c)

            _hook_all(self)
            try:
                with run_eagerly(), _autograd.pause():
                    Block.__call__(self, *inputs)
            finally:
                for h in handles:
                    h.detach()

        rows = []

        def _walk(b, depth):
            n = sum(int(np.prod(p.shape)) for p in b._params.values()
                    if p.shape is not None)
            rows.append(("  " * depth + type(b).__name__, b.name, n,
                         shapes.get(id(b), "")))
            for c in b._children.values():
                if c is not None:
                    _walk(c, depth + 1)
        _walk(self, 0)
        total = sum(int(np.prod(p.shape))
                    for p in self.collect_params().values()
                    if p.shape is not None)
        shp = bool(shapes)
        hdr = f"{'Layer':<34}{'Name':<24}{'Params':>10}"
        if shp:
            hdr += f"  {'Output Shape'}"
        lines = [hdr, "-" * (80 if shp else 68)]
        for a, b, c, sh in rows:
            line = f"{a:<34}{b:<24}{c:>10}"
            if shp:
                line += f"  {sh}"
            lines.append(line)
        lines += ["-" * (80 if shp else 68),
                  f"{'Total params:':<58}{total:>10}"]
        print("\n".join(lines))

    # ---------------------------------------------------------------- save --
    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural name (``features.0.weight``),
        independent of the name scopes."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            if child is not None:
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Every parameter by structural name, in ``nd.save``'s
        container."""
        from .. import ndarray as nd
        nd.save(filename, {k: p.data() for k, p in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set parameters from a ``save_parameters`` file (either
        package's); values are cast to each parameter's dtype."""
        from .. import ndarray as nd
        loaded = nd.load(filename, ctx="cpu")
        by_key = self._collect_params_with_prefix()
        for key, p in by_key.items():
            if key in loaded:
                if p._nd is None:
                    p.initialize(ctx=ctx)
                p.set_data(loaded[key])
            elif not allow_missing:
                raise ValueError(f"missing parameter '{key}' in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(by_key)
            if extra:
                raise ValueError(f"extra parameters in {filename}: "
                                 f"{sorted(extra)}")

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A block written as ``hybrid_forward(F, x, *args, **params)`` (or
    with its own ``forward``) that ``hybridize()`` runs as one unit."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached = None
        self._export_spec = None        # the last hybridized call's inputs

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run every call of this block as one unit (the JAX package's
        CachedOp; ``static_alloc``/``static_shape`` are accepted and
        implied: a graph's buffers are static).  Recurses into the
        children; ``active=False`` goes back to eager calls.

        The unit is the block's whole call (``forward`` or
        ``hybrid_forward``), run through ``parallel.functional_call``
        over detached aliases of the parameters (the same storage, so
        the optimizers' in-place updates are seen), with the running
        statistics the forward replaced copied into the parameters' own
        storage.  Calls are keyed by the inputs' structure, shapes,
        dtypes and devices, ``autograd.is_training()`` and whether the
        call records:

        - not recording: the forward alone;
        - recording: one autograd node (``_CachedFunction``) for the
          whole block, whose backward computes the inputs' and the
          trainable parameters' gradients from the node's own forward
          and returns them, so the parameters' gradient buffers take
          them by ``grad_req`` as in an eager call.  It differentiates
          once: ``create_graph=True`` through it raises, and a second
          backward of one call raises.

        On the card (``graphs``): a key's first call runs eagerly on its
        capture stream; the forward alone is then captured, and a
        recording key's forward and backward are captured as a pair over
        one memory pool after its first backward; later calls copy their
        inputs into static buffers, replay, and return clones of the
        static outputs.  A recording call made while an earlier replayed
        call of its key still awaits its backward (whose activations the
        replay would overwrite) runs eagerly on the capture stream.  A
        capture that fails raises.  On the CPU the same bodies run
        without capture.

        Calls run the eager body inside another hybridized block's unit,
        inside ``functional_call`` (the training steps) and during any
        capture, as the JAX package does for traced arguments.  The
        first call sizes deferred parameters with one eager dry run
        (not recording).  A parameter whose tensor was rebound since
        the graphs were made (``cast``, ``initialize(force_reinit=
        True)``, ``reset_ctx``, an assignment to ``_data``) drops them:
        each call checks every parameter's tensor by identity.
        ``set_data`` copies in place and keeps them.  Forward hooks fire
        when the body runs in Python: every CPU call, and on the card
        its warm-up and capture (the JAX package: while tracing)."""
        self._active = bool(active)
        self._cached = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def graph_count(self):
        """Captured units held: one per key seen on the card (a
        recording key's unit is a forward and a backward graph)."""
        return 0 if self._cached is None else self._cached.graph_count()

    def infer_shape(self, *args):
        """Layer hook: fill the wildcard (0) dims of own parameters from
        the inputs of the first forward."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer parameter shapes; "
            f"initialize with fully-specified shapes")

    def _ensure_init(self, *args):
        if any(p._deferred_init is not None
               for p in self._reg_params.values()):
            self.infer_shape(*args)
            for p in self._reg_params.values():
                if p._deferred_init is not None:
                    p._finish_deferred_init()

    def __call__(self, *args):
        if not self._active or running_eagerly():
            return super().__call__(*args)
        wrap = any(isinstance(a, NDArray) for a in args)
        targs = tuple(a._data if isinstance(a, NDArray) else a
                      for a in args)
        leaves, spec = _flatten(targs)
        self._export_spec = spec
        if any(t.is_cuda for t in leaves) and \
                torch.cuda.is_current_stream_capturing():
            return super().__call__(*args)
        if self._cached is None or not self._cached.current():
            if any(p._deferred_init is not None
                   for p in self.collect_params().values()):
                with run_eagerly(), _autograd.pause():
                    super().__call__(*targs)
            self._cached = _CachedOp(self)
        out = self._cached(leaves, spec)
        return _wrap_all(out, _out_class(args)) if wrap else out

    def forward(self, x, *args):
        try:
            params = {k: p.tensor() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._ensure_init(x, *args)
            params = {k: p.tensor() for k, p in self._reg_params.items()}
        return self.hybrid_forward(_ops, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """ref: HybridBlock.export — ``path-symbol.json`` (a descriptor),
        ``path-NNNN.params`` (``save_parameters``'s structural names) and
        ``path-graph.pt2``: the inference forward as a ``torch.export``
        program taking the parameters (in ``param_order``) and the
        inputs of the last hybridized call, on their devices.  The
        hand-written kernels appear in it as the ``mxnet_tpu_torch::``
        custom ops.  Returns the json's and the params file's paths."""
        if self._export_spec is None:
            raise RuntimeError(
                f"{type(self).__name__}.export: run one hybridized forward "
                f"first (hybridize() and call the block): the program is "
                f"traced at that call's input shapes")
        params_file = f"{path}-{epoch:04d}.params"
        self.save_parameters(params_file)
        names = sorted(self.collect_params().keys())
        plist = [self.collect_params()[n] for n in names]
        by_id = {id(p): k for k, p in
                 self._collect_params_with_prefix().items()}
        missing = [p.name for p in plist if id(p) not in by_id]
        if missing:
            raise ValueError(f"export: parameters {missing} lie outside the "
                             f"block's tree; the params file cannot hold "
                             f"them")
        spec = self._export_spec
        leaves = [torch.zeros(s[1], dtype=s[2], device=s[3])
                  for s in _leaf_specs(spec)]
        serve = _Serve(self, plist, spec)
        with torch.no_grad():   # inference: no grad-mode switch to record
            program = torch.export.export(
                serve, ([p.tensor().detach() for p in plist], *leaves))
        out_spec = serve.out_spec
        if out_spec[0] != _TENSOR and any(s[0] != _TENSOR
                                          for s in out_spec[1]):
            raise ValueError("export: the block must return a tensor or a "
                             "flat tuple of tensors")
        graph_file = f"{path}-graph.pt2"
        torch.export.save(program, graph_file)
        # file names are basenames, resolved against the json's directory
        meta = {"framework": "mxnet_tpu_torch", "block": type(self).__name__,
                "prefix": self._prefix,
                "params": os.path.basename(params_file),
                "graph": os.path.basename(graph_file),
                "param_order": [by_id[id(p)] for p in plist],
                "tuple_out": out_spec[0] != _TENSOR}
        with open(f"{path}-symbol.json", "w") as f:
            json.dump(meta, f, indent=2)
        return f"{path}-symbol.json", params_file


def _out_class(args):
    """The array class of a block's outputs for NDArray inputs:
    ``mx.np.ndarray`` under ``npx.set_np()`` or for an ``mx.np`` input,
    else None (NDArray)."""
    if _npx.is_np_array():
        return _np_ndarray
    for a in args:
        if isinstance(a, _np_ndarray):
            return _np_ndarray
    return None


# ------------------------------------------------------------- hybridize --
_TENSOR, _VALUE = "tensor", "value"


def _flatten(tree):
    """The tensors of a nested tuple/list ``tree``, and a hashable spec
    of the rest (structure, each tensor's shape, dtype and device, other
    leaves by value) that ``_unflatten`` rebuilds it from."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return (_TENSOR, tuple(x.shape), x.dtype, x.device)
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(v) for v in x))
        return (_VALUE, x)
    return leaves, walk(tree)


def _leaf_specs(spec):
    """The tensor leaves' specs of ``_flatten``'s spec, in order."""
    if spec[0] == _TENSOR:
        return [spec]
    if spec[0] == _VALUE:
        return []
    return [s for sub in spec[1] for s in _leaf_specs(sub)]


class _Serve(torch.nn.Module):
    """A block's inference forward over parameters passed in (what
    ``HybridBlock.export`` traces)."""

    def __init__(self, block, plist, spec):
        super().__init__()
        self.block, self.plist, self.spec = block, plist, spec

    def forward(self, params, *leaves):
        out, _ = functional_call(self.block, self.plist, list(params),
                                 _unflatten(self.spec, leaves), False)
        outs, self.out_spec = _flatten(out)
        return tuple(outs)


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s[0] == _TENSOR:
            return next(it)
        if s[0] == _VALUE:
            return s[1]
        return s[0](build(v) for v in s[1])
    return build(spec)


def _grads(outs, wrt, cts):
    """Gradients of ``outs`` (those that carry a graph) against ``wrt``
    seeded with ``cts``; None where one does not depend on them."""
    keep = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
    if not keep:
        return [None] * len(wrt)
    return list(torch.autograd.grad([o for o, _ in keep], wrt,
                                    [c for _, c in keep],
                                    allow_unused=True))


class _Pair:
    """A recording key's graphs on the card: the forward and, sharing
    its memory pool, the backward, with their static buffers."""

    def __init__(self, device):
        self.fwd = StepGraph(device)
        self.bwd = None
        self.warmed = False             # a backward ran eagerly
        self.gen = 0                    # forward replays so far
        self.pending = None             # weakref: a replay awaiting backward

    @property
    def captured(self):
        return self.bwd is not None

    def busy(self):
        return self.pending is not None and self.pending() is not None


class _CachedOp:
    """What a hybridized block runs as one unit: its parameters (sorted
    by name, as the JAX CachedOp takes them) and, on the card, its
    graphs by key."""

    def __init__(self, block):
        params = block.collect_params()
        self.block = weakref.ref(block)
        self.plist = [params[n] for n in sorted(params.keys())]
        self.tensors = [p.tensor() for p in self.plist]
        self.train = [i for i, t in enumerate(self.tensors)
                      if t.requires_grad]
        self.forward_graphs = None      # GraphCache of forward-only keys
        self.statics = {}               # forward-only key -> input buffers
        self.pairs = {}                 # recording key -> _Pair
        self.out_specs = {}             # key -> output structure

    def current(self):
        """No parameter's tensor was rebound since these were made."""
        return all(p._data is t for p, t in zip(self.plist, self.tensors))

    def graph_count(self):
        return len(self.forward_graphs or ()) + sum(
            p.captured for p in self.pairs.values())

    def aliases(self, trainable):
        """Detached aliases of the parameters' tensors; the trainable
        ones fresh leaves that record gradients when ``trainable``."""
        out = [t.detach() for t in self.tensors]
        if trainable:
            for i in self.train:
                out[i].requires_grad_(True)
        return out

    def body(self, key, leaves, spec, training, aliases):
        """The block's forward over ``aliases``: what runs eagerly on the
        CPU and in a card's warm-up, and what a card's graph holds.  Each
        parameter the forward replaced (running statistics) has its new
        value copied into its own storage.  Returns the output
        tensors."""
        out, mutated = functional_call(self.block(), self.plist, aliases,
                                       _unflatten(spec, leaves), training)
        with torch.no_grad():
            for i, new in mutated:
                aliases[i].copy_(new)
        outs, self.out_specs[key] = _flatten(out)
        return tuple(outs)

    def __call__(self, leaves, spec):
        training = _autograd.is_training()
        wrt_in = tuple(j for j, x in enumerate(leaves) if x.requires_grad)
        recording = _autograd.is_recording() and bool(self.train or wrt_in)
        key = (spec, training, recording, wrt_in if recording else ())
        device = (self.tensors or leaves or [torch.empty(0)])[0].device
        if not recording:
            if device.type == "cuda":
                outs = self._forward_graph(key, leaves, spec, training,
                                           device)
            else:
                outs = self.body(key, leaves, spec, training,
                                 self.aliases(False))
        else:
            call = self._recording_call(key, leaves, spec, training, wrt_in,
                                        device)
            with torch.enable_grad():
                outs = _CachedFunction.apply(
                    call, *leaves, *[self.tensors[i] for i in self.train])
        return _unflatten(self.out_specs[key], outs)

    # ------------------------------------------------------- the card --
    def _forward_graph(self, key, leaves, spec, training, device):
        if self.forward_graphs is None:
            self.forward_graphs = GraphCache(device)
        static = self.statics.get(key)
        if static is None:
            static = self.statics[key] = [x.detach().clone() for x in leaves]
        else:
            for s, x in zip(static, leaves):
                s.copy_(x)
        aliases = self.aliases(False)
        outs = self.forward_graphs.run(
            key, lambda: self.body(key, static, spec, training, aliases))
        return tuple(o.clone() for o in outs)

    def _recording_call(self, key, leaves, spec, training, wrt_in, device):
        if device.type != "cuda":
            return _EagerCall(self, key, spec, training, wrt_in)
        pair = self.pairs.get(key)
        if pair is None:
            pair = self.pairs[key] = _Pair(device)
        if not pair.warmed or pair.busy():
            return _EagerCall(self, key, spec, training, wrt_in, pair)
        if not pair.captured:
            self._capture_pair(pair, key, leaves, spec, training, wrt_in,
                               device)
        return _ReplayCall(self, pair, wrt_in)

    def _capture_pair(self, pair, key, leaves, spec, training, wrt_in,
                      device):
        """Capture a recording key's forward, then its backward into the
        forward's pool (capturing runs nothing: no statistic moves)."""
        static_in = [x.detach().clone().requires_grad_(j in wrt_in)
                     for j, x in enumerate(leaves)]
        aliases = self.aliases(True)
        wrt = [aliases[i] for i in self.train] + [static_in[j]
                                                  for j in wrt_in]
        outs = pair.fwd.capture(
            lambda: self.body(key, static_in, spec, training, aliases))
        cts = [torch.zeros_like(o) for o in outs]
        bwd = StepGraph(device, pool_of=pair.fwd)
        grads = bwd.capture(lambda: _grads(outs, wrt, cts))
        pair.static_in, pair.cts, pair.grads = static_in, cts, grads
        pair.outs = [o.detach() for o in outs]
        pair.bwd = bwd


def _expand(op, n_in, wrt_in, grads):
    """The Function's gradients: one per input leaf (None where it takes
    none), then one per trainable parameter."""
    k = len(op.train)
    by_input = dict(zip(wrt_in, grads[k:]))
    return tuple(by_input.get(j) for j in range(n_in)) + tuple(grads[:k])


class _EagerCall:
    """A recording call run eagerly: every one on the CPU, and on the
    card a key's calls until its first backward (on the pair's capture
    stream: its warm-up) or while a replay awaits its backward."""

    def __init__(self, op, key, spec, training, wrt_in, pair=None):
        self.op, self.key, self.spec = op, key, spec
        self.training, self.wrt_in, self.pair = training, wrt_in, pair
        self.outs = None

    def _run(self, fn):
        if self.pair is None:
            return fn()
        out = self.pair.fwd.warm_up(fn)
        main = torch.cuda.current_stream(self.pair.fwd.device)
        for t in out:                   # made on the capture stream
            if t is not None:
                t.record_stream(main)
        return out

    def forward(self, tensors):
        op = self.op
        self.n_in = len(tensors) - len(op.train)
        leaves = [x.detach().requires_grad_(j in self.wrt_in)
                  for j, x in enumerate(tensors[:self.n_in])]
        aliases = op.aliases(True)
        self.wrt = [aliases[i] for i in op.train] + [leaves[j]
                                                     for j in self.wrt_in]
        with torch.enable_grad():
            self.outs = self._run(lambda: op.body(
                self.key, leaves, self.spec, self.training, aliases))
        return tuple(o.detach() for o in self.outs)

    def backward(self, cts):
        if self.outs is None:
            raise RuntimeError(
                "backward through a hybridized block's recorded call runs "
                "once; its graph was spent by an earlier backward")
        outs, self.outs = self.outs, None
        grads = self._run(lambda: tuple(_grads(outs, self.wrt, cts)))
        if self.pair is not None:
            self.pair.warmed = True
        return _expand(self.op, self.n_in, self.wrt_in, grads)


class _ReplayCall:
    """A recording call through its key's captured pair."""

    def __init__(self, op, pair, wrt_in):
        self.op, self.pair, self.wrt_in = op, pair, wrt_in

    def forward(self, tensors):
        pair = self.pair
        self.n_in = len(tensors) - len(self.op.train)
        for s, x in zip(pair.static_in, tensors[:self.n_in]):
            s.copy_(x)
        pair.fwd.replay()
        pair.gen += 1
        self.gen = pair.gen
        pair.pending = weakref.ref(self)
        return tuple(o.clone() for o in pair.outs)

    def backward(self, cts):
        pair = self.pair
        if pair.gen != self.gen:
            raise RuntimeError(
                "a hybridized block was called again with the same input "
                "signature after this recorded call's backward, and the "
                "replay overwrote the activations a second backward of it "
                "needs")
        if pair.pending is not None and pair.pending() is self:
            pair.pending = None
        for s, c in zip(pair.cts, cts):
            s.copy_(c)
        pair.bwd.replay()
        grads = [None if g is None else g.clone() for g in pair.grads]
        return _expand(self.op, self.n_in, self.wrt_in, grads)


class _CachedFunction(torch.autograd.Function):
    """One autograd node for a hybridized block's recorded call: its
    inputs are the call's input tensors and the trainable parameters'
    tensors, whose gradient hooks then fill their ``grad`` buffers."""

    @staticmethod
    def forward(ctx, call, *tensors):
        outs = call.forward(tensors)
        ctx.call = call
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *cts):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "a hybridized block differentiates once: its backward "
                "records no graph, so create_graph=True (a higher-order "
                "gradient) through it is not possible; call "
                "hybridize(active=False) to run it eagerly")
        return (None,) + ctx.call.backward(cts)


class SymbolBlock(HybridBlock):
    """A block made from symbol outputs (ref: class SymbolBlock).

    Two forms of ``outputs``:

    - an ``mx.sym.Symbol`` graph and its ``inputs`` (Symbols or names):
      every other variable of the graph becomes a Parameter (aux states
      with ``grad_req="null"``), named as the variable, taken from
      ``params`` (a ``load_checkpoint`` dict; ``arg:``/``aux:`` prefixes
      accepted) or deferred until the first forward sizes it.  The
      forward walks the graph (``executor.walk_graph``) over the
      registry's ops on tensors, reading each parameter's tensor
      through ``Parameter._data`` — the route ``functional_call``
      swaps for aliases, so ``hybridize()`` captures it through
      ``_CachedOp`` and reads the live weights.  Loss-head label
      variables that are not inputs are fed zeros.  In training mode
      the running statistics the graph updates are written back;
    - a callable over ``nd`` arrays, with ``params`` its Parameters;
    - ``SymbolBlock.imports``: serving ``HybridBlock.export``'s pair.
    """

    def __init__(self, outputs, inputs=None, params=None, prefix=None):
        super().__init__(prefix=prefix)
        from .. import symbol as _symbol

        self._sym = None
        if isinstance(outputs, _symbol.Symbol):
            self._init_from_symbol(outputs, inputs, params)
            return
        if not callable(outputs):
            raise TypeError("SymbolBlock(outputs): outputs must be a Symbol "
                            "or a callable built from framework ops")
        self._fn = outputs
        if params:
            for name, p in (params.items() if hasattr(params, "items") else
                            ((p.name, p) for p in params)):
                self._params._params[name] = p

    def _init_from_symbol(self, outputs, inputs, params):
        from .. import symbol as _symbol

        self._sym = outputs
        if inputs is None:
            inputs = ["data"]
        if isinstance(inputs, (str, _symbol.Symbol)):
            inputs = [inputs]
        for s in inputs:
            if isinstance(s, _symbol.Symbol) and s._node.op is not None:
                raise ValueError(
                    f"SymbolBlock: input {s.name!r} is an op output, not a "
                    f"variable; graph cutting is not supported — rebuild the "
                    f"subgraph from a Variable (or bind the full symbol)")
        self._sym_inputs = [s.name if isinstance(s, _symbol.Symbol) else s
                            for s in inputs]
        arg_names = self._sym.list_arguments()
        aux_names = self._sym.list_auxiliary_states()
        unknown = [n for n in self._sym_inputs
                   if n not in arg_names and n not in aux_names]
        if unknown:
            raise ValueError(
                f"SymbolBlock: inputs {unknown} are not variables of the "
                f"symbol (its variables: {arg_names})")
        # loss-head label variables are inputs, never weights: zeros are
        # fed at forward unless the caller wires them as inputs
        self._label_vars = _symbol.label_variables(self._sym) \
            - set(self._sym_inputs)
        self._shape_cache = {}
        given = {}
        if params:
            items = params.items() if hasattr(params, "items") else \
                ((p.name, p) for p in params)
            for name, p in items:
                key = name.split(":", 1)[1] if name[:4] in ("arg:", "aux:") \
                    else name
                given[key] = p
        for n in arg_names + aux_names:
            if n in self._sym_inputs or n in self._label_vars:
                continue
            p = given.pop(n, None)
            if isinstance(p, Parameter):
                self._params._params[n] = p
                continue
            param = Parameter(n, shape=None, allow_deferred_init=True,
                              grad_req="null" if n in aux_names else "write")
            if p is not None:           # an array from load_checkpoint
                param.set_data(p)
            self._params._params[n] = param
        if given:
            # a key mismatch must not silently yield a random-init model
            raise ValueError(
                f"SymbolBlock: params {sorted(given)} match no argument of "
                f"the symbol (its arguments: {arg_names + aux_names})")

    def _arg_shapes(self, feed):
        """Every variable's shape for these inputs' shapes (memoised)."""
        from ..symbol import infer_arg_shapes

        key = tuple(tuple(feed[n].shape) for n in self._sym_inputs)
        if key not in self._shape_cache:
            self._shape_cache[key] = infer_arg_shapes(
                self._sym, {n: tuple(feed[n].shape)
                            for n in self._sym_inputs})
        return self._shape_cache[key]

    def forward(self, *args):
        if self._sym is None:
            out = self._fn(*[a if isinstance(a, NDArray) else NDArray(a)
                             for a in args])
            return _unwrap(out)
        from ..executor import walk_graph
        from ..ops.registry import get_op

        if len(args) != len(self._sym_inputs):
            raise ValueError(f"SymbolBlock: expected {len(self._sym_inputs)} "
                             f"inputs {self._sym_inputs}, got {len(args)}")
        feed = {n: a._data if isinstance(a, NDArray) else a
                for n, a in zip(self._sym_inputs, args)}
        params = self._params._params
        missing_labels = [n for n in self._label_vars if n not in feed]
        if missing_labels:
            shapes = self._arg_shapes(feed)
            dev = feed[self._sym_inputs[0]].device
            for n in missing_labels:
                feed[n] = torch.zeros(shapes[n], dtype=torch.float32,
                                      device=dev)
        pending = [p for p in params.values()
                   if p._nd is None and p._deferred_init is not None]
        if pending:
            # the first forward with known input shapes finishes deferred
            # init (ref: SymbolBlock parameter shape inference)
            shapes = self._arg_shapes(feed)
            for p in pending:
                p.shape = tuple(shapes[p.name])
                p._finish_deferred_init()

        def leaf(node):
            if node.name in feed:
                return feed[node.name]
            p = params[node.name]
            if p._nd is None:
                p.data()                # raises: not initialised
            return p._data

        def apply_op(node, ins, attrs):
            return get_op(node.op)(*ins, **attrs)

        def aux_update(name, v_new):
            if _autograd.is_training():
                params[name]._data = v_new.detach()

        outs = walk_graph(self._sym, leaf, apply_op, aux_update)
        return outs[0] if len(outs) == 1 else tuple(outs)

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, ctx=None):
        """ref: SymbolBlock.imports — a block serving the pair that
        ``HybridBlock.export`` wrote, without the defining class: its
        parameters load by structural name (on ``ctx``; None: the
        current context) and feed the ``torch.export`` program in its
        recorded order, under ``no_grad``.  ``input_names`` is accepted
        for API compatibility (the program's positional signature is
        authoritative).  A JAX package's artifact raises, naming that
        package: its graph is a StableHLO program."""
        return _imports(symbol_file, param_file, ctx)


def _imports(symbol_file, param_file=None, ctx=None):
    """``SymbolBlock.imports``' body: the block serving an exported pair."""
    from .. import ndarray as nd

    with open(symbol_file) as f:
        meta = json.load(f)
    framework = meta.get("framework")
    if framework == "mxnet_tpu":
        raise ValueError(
            f"{symbol_file} was exported by the JAX package (mxnet_tpu): "
            f"its graph is a StableHLO program, which mxnet_tpu_torch "
            f"cannot run; export the model from mxnet_tpu_torch")
    if framework != "mxnet_tpu_torch" or not meta.get("graph"):
        raise ValueError(
            f"{symbol_file} holds no graph exported by mxnet_tpu_torch; "
            f"re-export the model after one hybridized forward (or rebuild "
            f"the model class and use load_parameters)")
    base = os.path.dirname(os.path.abspath(symbol_file))
    params_path = param_file or os.path.join(base, meta["params"])
    loaded = nd.load(params_path, ctx=ctx)
    missing = [n for n in meta["param_order"] if n not in loaded]
    if missing:
        raise ValueError(f"params file {params_path} is missing graph inputs "
                         f"{missing}")
    program = torch.export.load(os.path.join(base, meta["graph"])).module()
    order = meta["param_order"]

    def fn(*args):
        tensors = [loaded[n]._data for n in order]
        leaves = [a._data if isinstance(a, NDArray) else a for a in args]
        with torch.no_grad():
            outs = program(tensors, *leaves)
        wrap = any(isinstance(a, NDArray) for a in args)
        outs = _wrap_all(tuple(outs)) if wrap else tuple(outs)
        return outs if meta["tuple_out"] else outs[0]

    blk = SymbolBlock(fn)
    for name, arr in loaded.items():
        p = Parameter(name, shape=arr.shape, grad_req="null")
        p._data = arr._data
        blk._params._params[name] = p
    return blk


def _unwrap(out):
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap(o) for o in out)
    return out


def params_from_jax(block, arrays):
    """Copy a JAX block's parameters into ``block``: ``arrays`` maps the
    JAX block's ``collect_params()`` names to numpy arrays, and must
    hold exactly this block's names (build both blocks with the same
    ``prefix``).  Values are cast to each parameter's dtype and device;
    a deferred parameter takes the array's shape."""
    params = block.collect_params()
    if set(params.keys()) != set(arrays):
        raise ValueError(
            f"parameter names differ: only in the port "
            f"{sorted(set(params.keys()) - set(arrays))}, only in the JAX "
            f"block {sorted(set(arrays) - set(params.keys()))}")
    for name, p in params.items():
        value = arrays[name]
        known = p.shape or ()
        if len(known) != value.ndim or any(
                s not in (0, v) for s, v in zip(known, value.shape)):
            raise ValueError(f"shape of {name}: port {p.shape}, JAX "
                             f"{tuple(value.shape)}")
        p.set_data(value)
