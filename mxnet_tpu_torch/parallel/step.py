"""The training and eval steps (the port of ``mxnet_tpu/parallel/step.py``'s
``TrainStep`` and ``EvalStep``, on one device).

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

Not ported yet: a device mesh (data parallelism) and gradient
compression (ROADMAP A15).  The prefetching feed is
``parallel.DevicePrefetcher``.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import autograd as _autograd
from .. import profiler as _profiler
from .. import telemetry as _telemetry
from ..elastic import NonFiniteAbortError
from ..fault import fire as _fire
from ..graphs import GraphCache
from .functional import (functional_call, param_names_and_values,
                         run_eagerly, trainable_split)
from .functional_opt import multi_update, state_template

__all__ = ["TrainStep", "EvalStep", "NonFiniteAbortError",
           "all_finite_rows"]


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
def _coerce(value, device):
    """A tensor (an NDArray's, or a numpy array) on ``device``; tuples
    and lists leaf by leaf, ``None`` as it is."""
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return tuple(_coerce(v, device) for v in value)
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    value = getattr(value, "_data", value)          # an NDArray's tensor
    if not isinstance(value, torch.Tensor):
        raise TypeError(f"the step takes NDArrays, torch tensors or numpy "
                        f"arrays, got {type(value).__name__}")
    return value.to(device)


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

    def __init__(self, net, loss_fn, optimizer, mesh=None,
                 loss_reduce="mean", donate_batch=False,
                 skip_nonfinite=False, nonfinite_budget=10, capture=None,
                 heartbeat=None):
        if mesh is not None:
            raise NotImplementedError("the port's TrainStep runs on one "
                                      "device; a mesh is not ported yet")
        if loss_reduce not in ("mean", "sum", "none"):
            raise ValueError(f"loss_reduce={loss_reduce!r}: 'mean', 'sum' "
                             f"or 'none'")
        self.net = net
        self._loss_reduce = loss_reduce
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._skip_nonfinite = bool(skip_nonfinite)
        self._nonfinite_budget = nonfinite_budget
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

    # --------------------------------------------------------------- build --
    def _build(self, data_args, device):
        net = self.net
        if device.type != "cuda" and self._capture:
            raise ValueError(f"TrainStep(capture=True): a CUDA graph needs "
                             f"the card, and the net's parameters lie on "
                             f"{device}; pass capture=None or False")
        self._graphs = GraphCache(device) \
            if device.type == "cuda" and self._capture is not False else None
        self._static = {}
        _build_deferred(net, data_args)
        names, plist, tensors = param_names_and_values(net)
        self._names, self._plist = names, plist
        self._train_idx, self._aux_idx = trainable_split(plist)
        self._train = [tensors[i].detach().clone().requires_grad_(True)
                       for i in self._train_idx]
        self._aux = [tensors[i].detach().clone() for i in self._aux_idx]
        self._states = [state_template(self.optimizer, tensors[i])
                        for i in self._train_idx]
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
        """Forward, loss, backward, the update and the write-back, on the
        step's tensors: what one eager call runs and one graph holds.
        Returns ``(loss, finite flag or None)``."""
        tensors = [None] * len(self._plist)
        for i, t in zip(self._train_idx, self._train):
            tensors[i] = t
        for i, t in zip(self._aux_idx, self._aux):
            tensors[i] = t
        with _autograd.record(train_mode=True):
            out, mutated = functional_call(self.net, self._plist, tensors,
                                           data_args, training=True)
            loss = self.loss_fn(out, label)
            loss = (loss.mean() if self._loss_reduce == "mean"
                    else loss.sum()).float()
        grads = torch.autograd.grad(loss, self._train)
        loss = loss.detach()
        with torch.no_grad():
            finite = None
            if self._skip_nonfinite:
                # x * 0 is 0 where x is finite and NaN elsewhere
                zeros = torch.stack(torch._foreach_norm(
                    torch._foreach_mul(list(grads), 0.0)))
                finite = torch.isfinite(loss).all() \
                    & torch.isfinite(zeros).all()
            t1 = self._t + 1
            multi_update(self.optimizer, self._train, list(grads),
                         self._states, t1, self._lr, self._lr_mults,
                         self._wd_mults, finite)
            for i, new in mutated:
                if i in self._aux_pos:
                    aux = self._aux[self._aux_pos[i]]
                    new = new.to(aux.dtype)
                    aux.copy_(new if finite is None
                              else torch.where(finite, new, aux))
            self._t.copy_(t1 if finite is None
                          else torch.where(finite, t1, self._t))
        return loss, finite

    # ---------------------------------------------------------------- call --
    def __call__(self, data, label):
        return self.step(data, label)

    def step(self, data, label):
        with _profiler.scope("TrainStep.step", cat="step"):
            return self._step(data, label)

    def _step(self, data, label):
        _fire("step")
        t_wall = time.perf_counter()
        tr = _telemetry.maybe_trace("step", server="TrainStep") \
            if _telemetry.ACTIVE else None
        sp = None if tr is None else tr.open("h2d", parent=tr.root)
        device = _device_of(self.net)
        data, label = _coerce(data, device), _coerce(label, device)
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
                self._plist[i]._data.copy_(t)
            for i, t in zip(self._aux_idx, self._aux):
                self._plist[i]._data.copy_(t)

    @property
    def params(self):
        """The step's tensors by parameter name."""
        full = [None] * len(self._plist)
        for i, t in zip(self._train_idx, self._train):
            full[i] = t
        for i, t in zip(self._aux_idx, self._aux):
            full[i] = t
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
    outputs are cloned."""

    def __init__(self, net, mesh=None):
        if mesh is not None:
            raise NotImplementedError("the port's EvalStep runs on one "
                                      "device; a mesh is not ported yet")
        self.net = net
        self._built = False
        self._rebuild = {}       # input signature -> output structure
        self._lock = threading.Lock()

    def _build(self, data, device):
        self._graphs = GraphCache(device) if device.type == "cuda" \
            else None
        self._static = {}
        _build_deferred(self.net, data)
        _names, plist, tensors = param_names_and_values(self.net)
        self._plist = plist
        self._tensors = [t.detach().clone() for t in tensors]
        self._built = True

    def _body(self, *data):
        with torch.no_grad(), _autograd.pause():
            out, _ = functional_call(self.net, self._plist, self._tensors,
                                     data, training=False)
        leaves, self._rebuild[_signature(data)] = _flatten(out)
        return leaves

    def __call__(self, *data):
        device = _device_of(self.net)
        data = tuple(_coerce(d, device) for d in data)
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
