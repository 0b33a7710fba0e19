"""The training and eval steps (the port of ``mxnet_tpu/parallel/step.py``'s
``TrainStep`` and ``EvalStep``).

Usage, as with the JAX package::

    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", learning_rate=0.1,
                                               momentum=0.9, wd=1e-4))
    loss = step(x, y)          # forward, loss, backward, SGD update
    step.sync_params_to_net()  # the step's parameters into the net
    out = parallel.EvalStep(net)(x)   # inference forward

``data`` and ``label`` may each be one tensor (or NDArray, or numpy
array) or a tuple/list of them (``None`` leaves pass through): the net
is called as ``net(*data)`` and
the loss as ``loss_fn(out, label)``, a one-element label tuple unwrapped
— e.g. BERT pretraining with ``data = (tokens, token_types, None,
masked_positions)`` and ``label = (mlm_labels, mlm_weights,
nsp_labels)``.

The step owns copies of the net's parameters (made at the first call).
Each call runs the forward in training mode, the loss reduced over the
batch in f32 (``loss_reduce``: ``"mean"``, the default, or ``"sum"``;
``"none"`` sums too, as in the JAX step), the backward, the optimizer
update (any rule of the JAX step's: SGD, NAG, Adam, AdamW, LAMB, LARS,
RMSProp, AdaGrad, Signum) at step count
``t = num_update + 1`` from f32 master weights for half-precision
parameters (with each parameter's ``lr_mult``/``wd_mult``;
``functional_opt.multi_update``), and the write-back of the BatchNorm
running statistics — what the JAX step's one compiled program does.
The update and the write-back are **in place** on the step's tensors;
the step count ``t`` and the learning rate are 0-d tensors on the
device (the host writes the scheduler's rate into the latter before
each call).

**Captured.**  On the card the step body is captured into one CUDA graph
(``graphs.GraphCache``) per input signature — the structure, shapes and
dtypes of the data and label leaves, as the JAX step's ``sig`` — over
static input buffers: the first call of a signature runs the body
eagerly on the capture stream (that call's step) and then captures it;
every later call copies its leaves into the buffers and replays the
graph.  ``graph_count()`` says how many graphs are held.
``capture=False`` runs the same body eagerly on every call (the
counterpart of ``jax.disable_jit``); on the CPU the body always runs
eagerly, and ``capture=True`` there raises.  A capture that fails
raises: there is no fallback.

``skip_nonfinite=True`` computes a device flag (loss and every gradient
finite) and selects every new value — parameters, optimizer state,
running statistics and ``t`` — against its old one without a branch, as
the JAX step does; the host reads the flag once after the step (one
sync), counts the skip (also in the ``TrainStep::nonfinite_skips``
profiler counter) and raises ``NonFiniteAbortError`` after
``nonfinite_budget`` consecutive ones — after draining every queued
asynchronous snapshot (``checkpoint.flush_pending``), so the last good
state is on disk when a supervisor looks at the wreck.

The runtime around training: ``heartbeat=`` takes an
``elastic.Heartbeat``, stamped with ``compile_in_progress=True`` before a
signature's first (capturing) call and with the step count and the
call's host milliseconds after every step (no added sync);
``parallel.checkpoint`` (``CheckpointManager``, ``save_train_step``,
``load_train_step``, ``resume_latest``) snapshots the step's tensors and
loads them back in place, into the tensors a captured graph holds.
While the profiler or telemetry records, each call is a
``TrainStep.step`` span carrying the ``DevicePrefetcher`` consumer wait
accrued since the last one (``feed_wait_ms``).

The net's own calls inside the step run eagerly even when it is
hybridized (``functional_call``): the step is the captured unit, and
no capture nests in another.

``donate_batch`` is accepted: without XLA's buffer donation there is
nothing to donate (a captured step copies the batch into its static
buffers either way).

**Data parallel.**  ``mesh=`` (default ``default_mesh()``: one ``dp``
axis over every rank of the process group, a mesh of one outside one)
runs the step on each rank over its **local shard** of the batch, as a
``jax.distributed`` process feeds its own shard: ``step(data, label)``
on rank r takes rank r's rows.  At the first call rank 0's parameters
are broadcast, so every rank starts alike.  ``grad_reduce`` picks the
gradient exchange:

- ``"f32"`` computes what the JAX step's SPMD program computes on the
  global batch: each rank's loss is its share of the global loss, the
  gradients are all-reduced (one collective per dtype over the leaves
  laid side by side), the loss too, and ``BatchNorm``/
  ``FusedNormReluConv`` take their statistics over the global batch
  (``ops.nn.stats_over``: the per-channel sums all-reduced in the
  forward, their gradients in the backward), so every rank holds the
  same parameters, running statistics and loss;
- ``"bf16"``/``"int8"`` are the JAX step's explicit path: the local
  gradients of the local loss go through ``quantize.reduce_gradients``
  (stochastic rounding from this rank's own stream, ``random.
  generator(device, salt)``), the loss is averaged (or summed) over the
  ranks, batch statistics are the shard's own and the float running
  statistics are averaged afterwards.

A loss written to reduce the batch to a scalar itself is reduced per
rank and averaged over the ranks (a divergence from the JAX step, which
reduces it over the global batch: the two agree where every rank's
reduction weighs alike).  ``BERTPretrainLoss`` takes its weighted
mean's denominator over the global batch (``ops.nn.batch_mean``), so
its value and gradients are the JAX step's.  Dropout draws per rank (``random``: rank r > 0 folds its rank into the
device streams).  Over NCCL the collectives are captured in the step's
graph; over gloo (ranks sharing one card, or the CPU) a collective
goes through the host and cannot be captured, so there the step runs
eagerly (``capture=True`` raises).  ``skip_nonfinite`` reads the flag of
the reduced gradients and loss, so a NaN on one rank skips the step on
every rank.  The prefetching feed is ``parallel.DevicePrefetcher``.

**Model parallel.**  A mesh with ``tp``, ``fsdp``, ``sp``, ``pp`` or
``ep`` axes and ``rules=`` (``ShardingRules``, ``tp_dense_rules()``,
``fsdp_rules()``, a block's ``sharding_rules()``) places each leaf as the
JAX step does (``param_sharding``; a spec that does not divide the shape
replicates, as ``_spec_fits`` decides there), and GSPMD's rule holds: a
layout changes where values live, never what they are.  Each rank keeps
only its block of a sharded leaf (``parallel.placement``), and of its
optimizer states and f32 master; every rank starts from rank 0's whole
values.  The batch splits over ``dp`` x ``fsdp`` (``batch_spec``) and
every rank of ``tp``, ``sp``, ``pp`` and ``ep`` feeds the same rows.  In
the forward a ``Dense`` split over a non-batch axis multiplies by its
block (column- or row-parallel), an ``Embedding`` split on its features
looks up in its block, ``PipelineStack``/``MoEFFN`` run their stages and
experts by block, and any other use gathers the leaf where it is used
and lets the gathered copy go (the backward gathers again).  Gradients
come back in the leaf's placement (summed over ``fsdp`` by the gather's
backward, the block's own over ``tp``/``sp``/``pp``/``ep``) and are
summed over the batch axes that do not split the leaf; LAMB's and
LARS's norms are those of the whole leaf.  ``skip_nonfinite`` agrees on
every rank (one scalar all-reduce over the world when a leaf is sharded,
also over ``dp``/``fsdp`` alone: a non-finite element of one rank's
block is seen by that rank only).  ``grad_reduce="bf16"``/``"int8"`` on such a mesh raise the
JAX step's ``ValueError``; ``params`` and ``sync_params_to_net`` gather
the whole values (a collective: every rank calls them).
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from .. import autograd as _autograd
from .. import profiler as _profiler
from .. import telemetry as _telemetry
from ..elastic import NonFiniteAbortError
from ..fault import fire as _fire
from .. import distributed as _dist
from .. import random as _random
from ..graphs import GraphCache
from ..ops.nn import stats_over
from . import mesh as _mesh
from . import quantize as _quantize
from .functional import (functional_call, param_names_and_values,
                         run_eagerly, trainable_split)
from .functional_opt import multi_update, state_template
from .placement import Placement, place, regathering
from .sharding import (NamedSharding, ShardingRules, batch_spec,
                       param_sharding, shards_any)

__all__ = ["TrainStep", "EvalStep", "NonFiniteAbortError",
           "all_finite_rows", "add_transfer_hook", "remove_transfer_hook"]

# decorrelates the gradient quantizer's rounding stream from dropout's
_GRADQ_SALT = 0x6A5D

# Observers of real host->device batch transfers: ``fn(leaf, sharding)``
# runs before each leaf the step (or a DevicePrefetcher placing for a
# sharding) copies to the device, and not for a leaf already there.
_TRANSFER_HOOKS = []


def add_transfer_hook(fn):
    """Register ``fn(leaf, sharding)`` to run on every real batch H2D
    copy."""
    _TRANSFER_HOOKS.append(fn)
    return fn


def remove_transfer_hook(fn):
    _TRANSFER_HOOKS.remove(fn)


def _put_leaf(leaf, device, sharding):
    """One batch leaf (the rank's local shard) on ``device``; the
    transfer hooks see every leaf that is not already there."""
    if isinstance(leaf, torch.Tensor) and leaf.device == device:
        return leaf
    for fn in _TRANSFER_HOOKS:
        fn(leaf, sharding)
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.to(device)


def _placements(mesh, rules, names, tensors):
    """``(shardings, placements)`` of the leaves: a ``Placement`` where
    the rules split a leaf over an axis of size > 1, else None."""
    shapes = [tuple(t.shape) for t in tensors]
    shardings = param_sharding(names, shapes, mesh, rules)
    return shardings, [Placement(mesh, sh.spec, shape) if shards_any(sh)
                       else None for sh, shape in zip(shardings, shapes)]


def _mesh_groups(mesh):
    """Make every axis's process group now, on every rank alike (the
    axes' groups are made together, collectively)."""
    for axis in mesh.axis_names:
        mesh.group(axis)


def _held(t, placement, grad=False):
    """The step's own copy of a leaf: this rank's block under
    ``placement``."""
    t = t.detach()
    t = (t if placement is None else placement.local(t)).clone()
    if grad:
        t.requires_grad_(True)
    return t if placement is None else place(t, placement)


def _batch_axes(mesh):
    """The mesh's axes of size > 1 that split the batch, and the number
    of batch shards they make."""
    axes = tuple(a for a in _mesh.BATCH_AXES if mesh.shape.get(a, 1) > 1)
    return axes, int(np.prod([mesh.shape[a] for a in axes]))


def _summer(mesh, axes):
    """``fn(t)``: ``t`` summed in place over every rank of ``axes``."""
    def fn(t):
        for axis in axes:
            _dist.all_reduce_(t, mesh.group(axis))
        return t
    return fn


def _whole(t):
    """A held leaf's whole value (gathered where it is sharded)."""
    p = getattr(t, "_placement", None)
    return t if p is None else p.gather(t.detach())


def all_finite_rows(arrays):
    """Per-example all-finite verdict over batch-major arrays: the
    serving-side counterpart of ``TrainStep(skip_nonfinite=True)``'s
    guard, taken per ROW so a server fails exactly the poisoned request
    of a batch.  ``arrays`` is one array or a list of them (numpy
    arrays, torch tensors on any device, NDArrays) whose leading axis
    is the batch; returns a host bool mask of shape ``(batch,)``.  A
    tensor is reduced where it lies and one bool per row comes back."""
    mask = None
    for a in arrays if isinstance(arrays, (list, tuple)) else (arrays,):
        x = getattr(a, "_data", a)      # an NDArray's tensor
        if isinstance(x, torch.Tensor):
            m = torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1) \
                .cpu().numpy()
        else:
            x = np.asarray(x)
            m = np.isfinite(x.reshape((x.shape[0], -1))).all(axis=1)
        mask = m if mask is None else np.logical_and(mask, m)
    return np.asarray(mask)


# ------------------------------------------------------ batch structure --
def _coerce(value, device, sharding=None):
    """A tensor (an NDArray's, or a numpy array) on ``device``; tuples
    and lists leaf by leaf, ``None`` as it is."""
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return tuple(_coerce(v, device, sharding) for v in value)
    value = getattr(value, "_data", value)          # an NDArray's tensor
    if not isinstance(value, (torch.Tensor, np.ndarray)):
        raise TypeError(f"the step takes NDArrays, torch tensors or numpy "
                        f"arrays, got {type(value).__name__}")
    return _put_leaf(value, device, sharding)


def _nd_class(tree):
    """For a batch holding NDArrays, the class of the step's output
    (``mx.np.ndarray`` for an ``mx.np`` leaf, else ``NDArray``); None
    for tensors and numpy arrays."""
    from ..ndarray.ndarray import NDArray
    from ..numpy import ndarray as np_ndarray

    leaves, found = [tree], None
    while leaves:
        x = leaves.pop()
        if isinstance(x, (tuple, list)):
            leaves.extend(x)
        elif isinstance(x, np_ndarray):
            return np_ndarray
        elif isinstance(x, NDArray):
            found = NDArray
    return found


def _signature(x):
    """Structure, shapes and dtypes of a batch: one graph each."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_signature(v) for v in x)
    return tuple(x.shape), x.dtype


def _clone(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x.clone()


def _copy_into(static, x):
    if isinstance(static, tuple):
        for s, v in zip(static, x):
            _copy_into(s, v)
    elif static is not None:
        static.copy_(x)


def _device_of(net):
    for p in net.collect_params().values():
        if p._data is not None:
            return p._data.device
        if p._deferred_init is not None:
            return torch.device(p._deferred_init[1])
    raise RuntimeError("the step: the net has no initialized parameters; "
                       "call net.initialize() first")


def _build_deferred(net, data_args):
    """Deferred shapes need only the feature dims: a batch-1 forward."""
    if any(p._deferred_init is not None
           for p in net.collect_params().values()):
        with run_eagerly(), _autograd.pause():
            net(*(a if a is None else a[:1] for a in data_args))


def _broadcast_flat(tensors, group, root=0):
    """``root``'s values into every rank's ``tensors``, in place: one
    broadcast per dtype over the tensors laid side by side."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _dist.broadcast_(flat, root, group)
        o = 0
        for t in ts:
            t.copy_(flat[o:o + t.numel()].reshape(t.shape))
            o += t.numel()


def _through_graphs(graphs, statics, body, args):
    """``body(*args)`` through the graph of ``args``' signature in
    ``graphs``, over static copies of ``args`` kept in ``statics``."""
    sig = _signature(args)
    static = statics.get(sig)
    if static is None:
        static = statics[sig] = _clone(args)
    else:
        _copy_into(static, args)
    out = graphs.run(sig, lambda: body(*static))
    return tuple(None if o is None else o.clone() for o in out)


def _finish_trace(tr, error=None):
    """Export a step's trace on a failing path (the flight recorder's
    bundle then holds the step that died); never raises."""
    if tr is None:
        return
    try:
        if error is not None:
            cls = error if isinstance(error, type) else type(error)
            tr.root.attrs["error"] = cls.__name__
        tr.root.end()
        tr.finish()
    except Exception:   # noqa: BLE001 — tracing never worsens a death
        pass


# ------------------------------------------------------------ train step --
class TrainStep:
    """``step(data, label)`` -> the loss, updating the step's params."""

    def __init__(self, net, loss_fn, optimizer, mesh=None, rules=None,
                 data_spec=None, loss_reduce="mean", donate_batch=False,
                 skip_nonfinite=False, nonfinite_budget=10,
                 grad_reduce="f32", heartbeat=None, capture=None):
        if loss_reduce not in ("mean", "sum", "none"):
            raise ValueError(f"loss_reduce={loss_reduce!r}: 'mean', 'sum' "
                             f"or 'none'")
        self.net = net
        self.mesh = mesh if mesh is not None else _mesh.default_mesh()
        self.rules = rules or ShardingRules()
        self._data_pspec = data_spec if data_spec is not None \
            else batch_spec(self.mesh)
        self._loss_reduce = loss_reduce
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._skip_nonfinite = bool(skip_nonfinite)
        self._nonfinite_budget = nonfinite_budget
        if grad_reduce not in _quantize.GRAD_REDUCE_MODES:
            raise ValueError(
                f"TrainStep: grad_reduce={grad_reduce!r} not in "
                f"{_quantize.GRAD_REDUCE_MODES}")
        if grad_reduce != "f32":
            if "dp" not in self.mesh.shape:
                raise ValueError(
                    f"TrainStep: grad_reduce={grad_reduce!r} needs a "
                    f"'dp' mesh axis to reduce over (mesh axes: "
                    f"{dict(self.mesh.shape)})")
            extra = {a: s for a, s in self.mesh.shape.items()
                     if a != "dp" and s > 1}
            if extra:
                raise ValueError(
                    f"TrainStep: grad_reduce={grad_reduce!r} supports "
                    f"pure data-parallel meshes only; model-parallel "
                    f"axes {extra} shard the params the explicit "
                    f"reduction stage would replicate")
        self._grad_reduce = grad_reduce
        self._capture = capture
        self._heartbeat = heartbeat
        self.skipped_steps = 0
        self.consecutive_skips = 0
        self._skip_counter = _profiler.Counter(
            None, "TrainStep::nonfinite_skips")
        self._built = False
        self._num_update = optimizer.begin_num_update
        # the DevicePrefetcher consumer wait read at the last traced step
        self._feed_wait_seen = None

    @property
    def data_sharding(self):
        """How batch leaves lie over the mesh: what a DevicePrefetcher
        needs to place batches this step takes without a second copy."""
        return NamedSharding(self.mesh, self._data_pspec)

    # --------------------------------------------------------------- build --
    def _build(self, data_args, device):
        net = self.net
        if not self.mesh.covers_world():
            raise ValueError(
                f"TrainStep: the mesh's devices {self.mesh.devices.tolist()}"
                f" are not this run's ranks 0..{_dist.num_workers() - 1}")
        _mesh_groups(self.mesh)
        self._batch_axes, self._n_batch = _batch_axes(self.mesh)
        self._model_axes = tuple(a for a, n in self.mesh.shape.items()
                                 if n > 1 and a not in _mesh.BATCH_AXES)
        self._dp = self.mesh.shape.get("dp", 1)
        if device.type != "cuda" and self._capture:
            raise ValueError(f"TrainStep(capture=True): a CUDA graph needs "
                             f"the card, and the net's parameters lie on "
                             f"{device}; pass capture=None or False")
        host_comm = _dist.num_workers() > 1 and _dist.backend() == "gloo"
        if host_comm and self._capture:
            raise ValueError("TrainStep(capture=True): the process group "
                             "runs over gloo (ranks share a card), whose "
                             "collectives go through the host and cannot "
                             "be captured; pass capture=None or False")
        self._graphs = GraphCache(device) \
            if device.type == "cuda" and self._capture is not False \
            and not host_comm else None
        self._static = {}
        _build_deferred(net, data_args)
        names, plist, tensors = param_names_and_values(net)
        self._param_shardings, where = _placements(self.mesh, self.rules,
                                                   names, tensors)
        self._names, self._plist = names, plist
        self._train_idx, self._aux_idx = trainable_split(plist)
        tensors = [t.detach().clone() for t in tensors]
        if _dist.num_workers() > 1:
            # every rank starts from rank 0's whole parameters
            with torch.no_grad():
                _broadcast_flat(tensors, None)
        self._train = [_held(tensors[i], where[i], grad=True)
                       for i in self._train_idx]
        self._aux = [_held(tensors[i], where[i]) for i in self._aux_idx]
        del tensors
        self._sharded = any(p is not None for p in where)
        self._norm_axes = [where[i].axes if where[i] is not None else ()
                           for i in self._train_idx]
        # the batch axes each gradient is summed over after the backward
        self._sum_axes = [tuple(a for a in self._batch_axes
                                if a not in axes) for axes in self._norm_axes]
        self._states = [state_template(self.optimizer, t)
                        for t in self._train]
        self._lr_mults = [plist[i].lr_mult for i in self._train_idx]
        self._wd_mults = [plist[i].wd_mult for i in self._train_idx]
        self._aux_pos = {i: k for k, i in enumerate(self._aux_idx)}
        self._t = torch.full((), self._num_update, dtype=torch.int32,
                             device=device)
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self._lr_value = None
        self._built = True

    def _base_lr(self):
        # at the post-increment count, as the JAX step evaluates it
        opt = self.optimizer
        if opt.lr_scheduler is not None:
            return float(opt.lr_scheduler(self._num_update + 1))
        return float(opt.lr)

    # ---------------------------------------------------------------- body --
    def _body(self, data_args, label):
        """Forward, loss, backward, the gradient exchange, the update and
        the write-back, on the step's tensors: what one eager call runs
        and one graph holds.  Returns ``(loss, finite flag or None)``."""
        tensors = [None] * len(self._plist)
        for i, t in zip(self._train_idx, self._train):
            tensors[i] = t
        for i, t in zip(self._aux_idx, self._aux):
            tensors[i] = t
        mode = self._grad_reduce
        split = bool(self._batch_axes)
        mean = self._loss_reduce == "mean"
        sync_stats = contextlib.nullcontext()
        if split and mode == "f32":
            sync_stats = stats_over(_summer(self.mesh, self._batch_axes),
                                    self._n_batch)
        gather = regathering() if self._sharded else contextlib.nullcontext()
        with _mesh.MeshScope(self.mesh), sync_stats, gather, \
                _autograd.record(train_mode=True):
            out, mutated = functional_call(self.net, self._plist, tensors,
                                           data_args, training=True)
            loss = self.loss_fn(out, label)
            loss = (loss.mean() if mean else loss.sum()).float()
        share = loss / self._n_batch if split and mode == "f32" and mean \
            else loss
        grads = list(torch.autograd.grad(share, self._train))
        loss = loss.detach()
        with torch.no_grad(), _mesh.MeshScope(self.mesh):
            if split:
                grads, loss, mutated = self._exchange(grads, share.detach(),
                                                      loss, mutated)
            finite = None
            if self._skip_nonfinite:
                # x * 0 is 0 where x is finite and NaN elsewhere
                zeros = torch.stack(torch._foreach_norm(
                    torch._foreach_mul(grads, 0.0)))
                finite = torch.isfinite(loss).all() \
                    & torch.isfinite(zeros).all()
                if self._sharded or self._model_axes:
                    # a rank sees only its blocks of a sharded leaf's
                    # gradient (and, over tp/sp/pp/ep, its own share of
                    # the others): agree on every rank
                    bad = (~finite).float()
                    finite = _dist.all_reduce_(bad, None, op="max") == 0
            t1 = self._t + 1
            multi_update(self.optimizer, self._train, grads,
                         self._states, t1, self._lr, self._lr_mults,
                         self._wd_mults, finite,
                         norm_axes=self._norm_axes if self._sharded
                         else None)
            for i, new in mutated:
                if i in self._aux_pos:
                    aux = self._aux[self._aux_pos[i]]
                    where = getattr(aux, "_placement", None)
                    if where is not None:      # the forward saw it whole
                        new = where.local(new)
                    new = new.to(aux.dtype)
                    aux.copy_(new if finite is None
                              else torch.where(finite, new, aux))
            self._t.copy_(t1 if finite is None
                          else torch.where(finite, t1, self._t))
        return loss, finite

    def _exchange(self, grads, share, loss, mutated):
        """The cross-rank reduction of one step: gradients, the loss and
        (on the explicit paths) the float running statistics."""
        dp, mode, reduce = self._dp, self._grad_reduce, self._loss_reduce
        if mode == "f32":
            # the gradients of each rank's share of the global loss,
            # summed over the batch axes that do not split the leaf
            grads = list(grads)
            for axis in self._batch_axes:
                idx = [k for k, axes in enumerate(self._sum_axes)
                       if axis in axes]
                if idx:
                    summed = _quantize.reduce_gradients(
                        [grads[k] for k in idx], axis,
                        self.mesh.shape[axis], "f32", reduce="sum")
                    for k, g in zip(idx, summed):
                        grads[k] = g
            for axis in self._batch_axes:
                share = _mesh.psum(share, axis)
            return grads, share, mutated
        key = _random.generator(self._train[0].device, salt=_GRADQ_SALT)
        grads = _quantize.reduce_gradients(grads, "dp", dp, mode, key=key,
                                           reduce=reduce)
        loss = (_mesh.pmean if reduce == "mean" else _mesh.psum)(loss, "dp")
        # per-shard running statistics: average the float ones; anything
        # else is taken as the same on every rank
        mutated = [(i, _mesh.pmean(m, "dp") if m.is_floating_point()
                    else m) for i, m in mutated]
        return grads, loss, mutated

    # ---------------------------------------------------------------- call --
    def __call__(self, data, label):
        return self.step(data, label)

    def step(self, data, label):
        """The loss of one update: an NDArray where the batch holds
        NDArrays (``mx.np.ndarray`` for those), as the JAX step returns
        one; else a tensor."""
        with _profiler.scope("TrainStep.step", cat="step"):
            loss = self._step(data, label)
        cls = _nd_class((data, label))
        if cls is None:
            return loss
        from ..ndarray.ndarray import _wrap
        return _wrap(loss.detach().clone(), cls)

    def _step(self, data, label):
        _fire("step")
        t_wall = time.perf_counter()
        tr = _telemetry.maybe_trace("step", server="TrainStep") \
            if _telemetry.ACTIVE else None
        sp = None if tr is None else tr.open("h2d", parent=tr.root)
        device = _device_of(self.net)
        data = _coerce(data, device, self.data_sharding)
        label = _coerce(label, device, self.data_sharding)
        data_args = data if isinstance(data, tuple) else (data,)
        if isinstance(label, tuple) and len(label) == 1:
            label = label[0]
        if sp is not None:
            sp.end()
        if self._heartbeat is not None and self._first_call(data_args,
                                                             label):
            # before the capturing call, so a supervisor's watchdog can
            # tell a long first call from a hung step
            self._heartbeat.beat(self._num_update, phase="train",
                                 compile_in_progress=True)
        if not self._built:
            self._build(data_args, device)
        lr = self._base_lr()
        if lr != self._lr_value:
            self._lr.fill_(lr)
            self._lr_value = lr
        sp = None if tr is None else tr.open("compute", parent=tr.root)
        try:
            if self._graphs is None:
                loss, finite = self._body(data_args, label)
            else:
                loss, finite = _through_graphs(self._graphs, self._static,
                                               self._body, (data_args,
                                                            label))
        except BaseException as exc:
            _finish_trace(tr, error=exc)
            raise
        if sp is not None:
            sp.end()
        if finite is not None and not bool(finite):   # the one sync
            self._skip(loss, tr)
        else:
            self._num_update += 1
            self.consecutive_skips = 0
            self.optimizer.num_update = self._num_update
            self._trace_done(tr)
        if self._heartbeat is not None:
            self._heartbeat.beat(self._num_update, last_step_ms=(
                time.perf_counter() - t_wall) * 1e3)
        return loss

    def _first_call(self, data_args, label):
        """Whether this call runs a signature for the first time (on the
        card: the call that captures its graph)."""
        if not self._built:
            return True
        return self._graphs is not None and \
            _signature((data_args, label)) not in self._graphs.held

    def _trace_done(self, tr):
        """Close a step's trace with the feed wait accrued since the last
        traced step (an attribute and a histogram: the wait came before
        this step's window opened)."""
        if tr is None:
            return
        try:
            w = _profiler.counter_value("DevicePrefetcher::consumer_wait_ms")
            if w is not None:
                seen = self._feed_wait_seen
                delta = 0.0 if seen is None else max(0.0, w - seen)
                self._feed_wait_seen = w
                tr.root.attrs["feed_wait_ms"] = round(delta, 3)
                _telemetry.registry().histogram(
                    "TrainStep::feed_wait_ms",
                    _telemetry.SPAN_MS_BUCKETS).observe(delta)
            tr.root.attrs["num_update"] = int(self._num_update)
            tr.root.end()
            tr.finish()
        except Exception:   # noqa: BLE001 — tracing never fails a step
            pass

    def graph_count(self):
        """CUDA graphs held: one per input signature seen on the card
        (0 when the step runs eagerly)."""
        return len(self._graphs) if self._built and self._graphs else 0

    def _skip(self, loss, tr):
        """Count a non-finite step; past the budget, export the step's
        trace, trip the flight recorder, let queued snapshots commit and
        raise ``NonFiniteAbortError``.  Closes ``tr`` when it raises."""
        self.skipped_steps += 1
        self.consecutive_skips += 1
        self._skip_counter.increment()
        budget = self._nonfinite_budget
        if budget is None or self.consecutive_skips < budget:
            self._trace_done(tr)
            return
        _finish_trace(tr, error=NonFiniteAbortError)
        _telemetry.flight_trip("nonfinite-abort", step=int(self._num_update),
                               consecutive_skips=self.consecutive_skips)
        try:
            from .checkpoint import flush_pending
            flush_pending(timeout=60.0)
        except Exception:  # noqa: BLE001 — the abort verdict must not be
            pass           # masked by a flush
        raise NonFiniteAbortError(
            f"TrainStep: {self.consecutive_skips} consecutive non-finite "
            f"updates (budget {budget}) at num_update="
            f"{self._num_update}; last loss={float(loss)}. "
            f"Params and optimizer state are unchanged since the last "
            f"finite step")

    # ---------------------------------------------------------------- sync --
    def sync_params_to_net(self):
        """Copy the step's parameters and running statistics into the
        net's Parameters."""
        with torch.no_grad():
            for i, t in zip(self._train_idx, self._train):
                self._plist[i]._data.copy_(_whole(t))
            for i, t in zip(self._aux_idx, self._aux):
                self._plist[i]._data.copy_(_whole(t))

    @property
    def params(self):
        """The step's tensors by parameter name (a sharded leaf's whole
        value, gathered: then every rank must ask)."""
        full = [None] * len(self._plist)
        with torch.no_grad():
            for i, t in zip(self._train_idx, self._train):
                full[i] = _whole(t)
            for i, t in zip(self._aux_idx, self._aux):
                full[i] = _whole(t)
        return dict(zip(self._names, full))


# ------------------------------------------------------------- eval step --
def _flatten(x):
    """A net's output as a tuple of leaves and a function that rebuilds
    the structure from them."""
    if isinstance(x, (tuple, list)):
        parts = [_flatten(v) for v in x]
        leaves = tuple(leaf for p in parts for leaf in p[0])

        def rebuild(ls):
            out, k = [], 0
            for p in parts:
                n = len(p[0])
                out.append(p[1](ls[k:k + n]))
                k += n
            return type(x)(out)
        return leaves, rebuild
    return (x,), lambda ls: ls[0]


class EvalStep:
    """``EvalStep(net)(*data)`` -> the net's outputs in inference mode.

    The step owns copies of the net's parameters, made at the first
    call (later changes to the net are not seen, as in the JAX step).
    Each call runs ``net(*data)`` without recording and in predict mode;
    on the card it is captured into one CUDA graph per input signature,
    as ``TrainStep`` does (eagerly on the CPU).  Returns the outputs in
    the net's structure (a one-element tuple unwrapped, as the JAX step
    does).

    Threads may share one step (the replicas of a serving fleet): a call
    holds the step's lock from filling the static inputs until the
    outputs are cloned.

    With a mesh (default ``default_mesh()``) each rank runs its local
    shard and gets its own rows' outputs back; with ``rules=`` over a
    model-parallel mesh it holds each sharded leaf's block and uses it
    as ``TrainStep`` does (every rank of the non-batch axes gets the
    same outputs)."""

    def __init__(self, net, mesh=None, rules=None, data_spec=None):
        self.net = net
        self.mesh = mesh if mesh is not None else _mesh.default_mesh()
        self.rules = rules or ShardingRules()
        self._data_pspec = data_spec if data_spec is not None \
            else batch_spec(self.mesh)
        self._built = False
        self._rebuild = {}       # input signature -> output structure
        self._lock = threading.Lock()

    @property
    def data_sharding(self):
        """See ``TrainStep.data_sharding``."""
        return NamedSharding(self.mesh, self._data_pspec)

    def _build(self, data, device):
        if not self.mesh.covers_world():
            raise ValueError(
                f"EvalStep: the mesh's devices {self.mesh.devices.tolist()}"
                f" are not this run's ranks 0..{_dist.num_workers() - 1}")
        self._graphs = GraphCache(device) if device.type == "cuda" \
            else None
        self._static = {}
        _build_deferred(self.net, data)
        _mesh_groups(self.mesh)
        names, plist, tensors = param_names_and_values(self.net)
        self._param_shardings, where = _placements(self.mesh, self.rules,
                                                   names, tensors)
        self._plist = plist
        tensors = [t.detach().clone() for t in tensors]
        if _dist.num_workers() > 1 and any(p is not None for p in where):
            with torch.no_grad():
                _broadcast_flat(tensors, None)
        self._tensors = [_held(t, p) for t, p in zip(tensors, where)]
        self._built = True

    def _body(self, *data):
        # ops that see the batch whole (MoE routing) take the global one
        axes, n = _batch_axes(self.mesh)
        whole = stats_over(_summer(self.mesh, axes), n) if axes \
            else contextlib.nullcontext()
        with torch.no_grad(), _autograd.pause(), \
                _mesh.MeshScope(self.mesh), whole:
            out, _ = functional_call(self.net, self._plist, self._tensors,
                                     data, training=False)
        leaves, self._rebuild[_signature(data)] = _flatten(out)
        return leaves

    def __call__(self, *data):
        device = _device_of(self.net)
        data = tuple(_coerce(d, device, self.data_sharding) for d in data)
        with self._lock:
            if not self._built:
                self._build(data, device)
            if self._graphs is None:
                leaves = self._body(*data)
            else:
                leaves = _through_graphs(self._graphs, self._static,
                                         self._body, data)
        res = self._rebuild[_signature(data)](leaves)
        if isinstance(res, tuple) and len(res) == 1:
            return res[0]
        return res

    def graph_count(self):
        """CUDA graphs held: one per input signature seen on the card."""
        return len(self._graphs) if self._built and self._graphs else 0
