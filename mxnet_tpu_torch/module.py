"""Module API (`mx.mod.Module`) — the classic symbolic training loop
(the port of ``mxnet_tpu/module.py``).

ref: python/mxnet/module/module.py — bind → init_params → init_optimizer →
fit/forward/backward/update, plus checkpointing.  The reference Module
owns a GraphExecutor per device and a kvstore; here the executor is
``executor.Executor`` (on the card: captured CUDA graphs, a forward and
backward pair a training step) and ``update`` runs the optimizer's eager
update on each parameter, writing in place.

Every write into a bound array is in place (``copy_``): the parameters
``bind`` preserves, those ``init_params``/``set_params`` set, and the
optimizer state a resumed ``fit`` loads, so the executor's graphs keep
reading the tensors they were captured with.  ``capture=False`` runs
the executor's programs eagerly on the card.
"""
from __future__ import annotations

import json
import logging
import os
import signal as _signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import callback as _callback
from . import elastic as _elastic
from . import fault as _fault
from . import telemetry as _telemetry
from . import initializer as _init
from . import metric as _metric
from . import optimizer as _opt
from .context import Context, current_context
from .io import DataBatch, DataDesc
from .ndarray import NDArray
from . import ndarray as nd
from .symbol import Symbol, load as _sym_load


def _assign(arr, value, name):
    """Write ``value`` (an NDArray, tensor or numpy array) into the bound
    array ``arr``, in place."""
    t = value._data if isinstance(value, NDArray) else \
        torch.as_tensor(np.asarray(value)) if not isinstance(
            value, torch.Tensor) else value
    if tuple(t.shape) != arr.shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"the bound {arr.shape}")
    with torch.no_grad():
        arr._data.copy_(t)


class Module:
    """ref: mx.mod.Module (single-executor form).  ``capture``: the
    executor's (None captures on the card, False runs eagerly)."""

    def __init__(self, symbol: Symbol, data_names=("data",),
                 label_names=("softmax_label",), context=None, logger=None,
                 capture=None):
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._ctx = context if isinstance(context, Context) \
            else current_context()
        self._capture = capture
        self._logger = logger or logging.getLogger(__name__)
        self._exec = None
        self._optimizer = None
        self._opt_states: Dict[str, object] = {}
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.for_training = False

    # ------------------------------------------------------------- binding --
    @property
    def symbol(self):
        return self._symbol

    def _param_names(self):
        skip = set(self._data_names) | set(self._label_names)
        return [n for n in self._symbol.list_arguments() if n not in skip]

    @staticmethod
    def _desc_shapes(descs):
        out = {}
        for d in descs or []:
            if isinstance(d, DataDesc):
                out[d.name] = tuple(d.shape)
            else:  # (name, shape) tuple
                out[d[0]] = tuple(d[1])
        return out

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write",
             shared_module=None):
        """ref: Module.bind — allocates the executor via simple_bind.

        ``shared_module``: an already-bound Module whose parameter, grad,
        and aux NDArrays this executor ALIASES (the reference's
        shared-executor memory sharing, used by BucketingModule so every
        bucket trains the same weights and one optimizer serves all)."""
        if self.binded and not force_rebind:
            return
        # a re-bind must not silently reset trained weights to zeros while
        # params_initialized stays True (the reference preserves params
        # across bind calls)
        preserved = None
        if self._exec is not None and self.params_initialized:
            preserved = self.get_params()
        shapes = self._desc_shapes(data_shapes)
        shapes.update(self._desc_shapes(label_shapes))
        req = grad_req if for_training else "null"
        if isinstance(req, str) and req != "null" and not inputs_need_grad:
            req = {n: ("null" if n in self._data_names or
                       n in self._label_names else req)
                   for n in self._symbol.list_arguments()}
        self._exec = self._symbol.simple_bind(self._ctx, grad_req=req,
                                              capture=self._capture,
                                              **shapes)
        if preserved is not None:
            arg, aux = preserved
            for src, dst in ((arg, self._exec.arg_dict),
                             (aux, self._exec.aux_dict)):
                for n, v in src.items():
                    if n in dst and dst[n].shape == v.shape:
                        _assign(dst[n], v, n)
        if getattr(self, "_monitor", None) is not None:
            self._monitor.install(self._exec)
        if shared_module is not None:
            src = shared_module._exec
            missing = [n for n in self._param_names()
                       if n not in src.arg_dict]
            if missing:
                raise ValueError(
                    f"bind(shared_module=...): parameters {missing} do not "
                    f"exist in the shared module — they would silently "
                    f"stay at zeros and never train")
            for n in self._param_names():
                self._exec.arg_dict[n] = src.arg_dict[n]
                if n in src.grad_dict and n in self._exec.grad_dict:
                    self._exec.grad_dict[n] = src.grad_dict[n]
            for n in self._symbol.list_auxiliary_states():
                if n in src.aux_dict:
                    self._exec.aux_dict[n] = src.aux_dict[n]
            self.params_initialized = shared_module.params_initialized
        self.binded = True
        self.for_training = for_training

    def _check_bound(self):
        if not self.binded:
            raise RuntimeError("Module: call bind() first")

    # -------------------------------------------------------------- params --
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """ref: Module.init_params."""
        self._check_bound()
        if self.params_initialized and not force_init:
            return
        if arg_params is None and aux_params is None and \
                getattr(self, "_preloaded", None):
            # Module.load(...) → bind → init_params restores the checkpoint
            # (the reference's load flow; random re-init here would silently
            # discard the loaded weights)
            arg_params, aux_params = self._preloaded
        initializer = initializer or _init.Uniform(0.01)
        if isinstance(initializer, str):
            initializer = _init.create(initializer)
        for n in self._param_names():
            arr = self._exec.arg_dict[n]
            if arg_params and n in arg_params:
                _assign(arr, arg_params[n], n)
            elif arg_params and not allow_missing:
                raise ValueError(f"init_params: missing {n} "
                                 f"(allow_missing=False)")
            else:
                _assign(arr, initializer(n, arr.shape, "float32"), n)
        for n in self._symbol.list_auxiliary_states():
            arr = self._exec.aux_dict[n]
            if aux_params and n in aux_params:
                _assign(arr, aux_params[n], n)
            else:
                _assign(arr, initializer(n, arr.shape, "float32"), n)
        self.params_initialized = True

    def get_params(self):
        """ref: Module.get_params — (arg_params, aux_params) snapshots."""
        self._check_bound()
        args = {n: self._exec.arg_dict[n].copy() for n in self._param_names()}
        aux = {n: a.copy() for n, a in self._exec.aux_dict.items()}
        return args, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # ----------------------------------------------------------- optimizer --
    @staticmethod
    def _attr_mults(symbol):
        """Per-parameter lr/wd multipliers from symbol attributes (ref:
        Module._create_optimizer reads __lr_mult__/__wd_mult__ from
        sym.attr_dict()).  A multiplier on a Variable applies to it; one in
        a layer's attr metadata applies to the layer's auto-created params
        (f'{layer}_...'), never to its data inputs."""
        lr, wd = {}, {}
        for n in symbol._topo_nodes():
            meta = dict(n.attrs.get("__meta__") or {})
            if n.op is None:
                for k in ("lr_mult", "wd_mult"):
                    if k in n.attrs:
                        meta.setdefault(k, n.attrs[k])
                targets = [n.name]
            else:
                targets = [s._node.name for s in n.inputs
                           if s._node.op is None
                           and s._node.name.startswith(n.name + "_")]
            if "lr_mult" in meta:
                for t in targets:
                    lr[t] = float(meta["lr_mult"])
            if "wd_mult" in meta:
                for t in targets:
                    wd[t] = float(meta["wd_mult"])
        return lr, wd

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """ref: Module.init_optimizer.  kvstore accepted for API compat —
        single-process Module updates locally; multi-device data
        parallelism is parallel.TrainStep territory."""
        self._check_bound()
        if self.optimizer_initialized and not force_init:
            return
        from_str = isinstance(optimizer, str)
        if from_str:
            self._optimizer = _opt.create(optimizer,
                                          **dict(optimizer_params or ()))
        else:
            self._optimizer = optimizer
        names = self._param_names()
        self._optimizer.idx2name = dict(enumerate(names))
        if from_str:
            # symbol-attr multipliers apply only to optimizers WE create;
            # a user-supplied instance keeps its own set_lr_mult choices
            # (ref: Module._create_optimizer)
            lrm, wdm = self._attr_mults(self._symbol)
            self._optimizer.lr_mult.update(lrm)
            self._optimizer.wd_mult.update(wdm)
        # stable name→index map so a shared optimizer (BucketingModule)
        # sees consistent indices from every bucket's update()
        self._opt_index = {n: i for i, n in enumerate(names)}
        self._opt_states = {
            n: self._optimizer.create_state_multi_precision(
                i, self._exec.arg_dict[n])
            for i, n in enumerate(names)}
        self.optimizer_initialized = True

    # ---------------------------------------------------- forward/backward --
    def forward(self, data_batch: DataBatch, is_train=None):
        """ref: Module.forward."""
        self._check_bound()
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feeds[name] = arr
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._check_bound()
        self._exec.backward(out_grads)

    def update(self):
        """ref: Module.update — one optimizer step on every parameter."""
        self._check_bound()
        if not self.optimizer_initialized:
            raise RuntimeError("Module: call init_optimizer() first")
        for i, n in enumerate(self._param_names()):
            g = self._exec.grad_dict.get(n)
            if g is None:
                continue
            self._optimizer.update_multi_precision(
                self._opt_index.get(n, i), self._exec.arg_dict[n], g,
                self._opt_states[n])

    def get_outputs(self):
        self._check_bound()
        return list(self._exec.outputs)

    def install_monitor(self, mon):
        """ref: Module.install_monitor — attach a mx.monitor.Monitor.
        Remembered across re-binds (a force_rebind would otherwise leave
        the monitor pointed at the dead executor)."""
        self._check_bound()
        self._monitor = mon
        mon.install(self._exec)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(list(labels), self.get_outputs())

    # ------------------------------------------------------------ training --
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, num_epoch=1, batch_end_callback=None,
            epoch_end_callback=None, force_rebind=False, force_init=False,
            prefetch=0, checkpoint_prefix=None, resume=False,
            bad_batch_budget=0):
        """ref: BaseModule.fit — the classic epoch loop.

        ``prefetch>0`` wraps ``train_data`` in ``mx.io.PrefetchingIter``
        with that queue capacity, overlapping decode/host work for the next
        batches with the current step.

        Fault tolerance:

        - ``checkpoint_prefix`` arms SIGTERM/SIGINT preemption handling —
          on signal the loop finishes the current batch, snapshots params
          + optimizer state + a ``<prefix>-resume.json`` position marker,
          and returns cleanly.
        - ``resume=True`` restores that snapshot (params, optimizer state,
          update counts) and continues MID-EPOCH from the recorded batch
          counter; with no snapshot present it trains from scratch.
        - ``bad_batch_budget`` tolerates that many data-pipeline errors
          (decode failures surfaced by ``PrefetchingIter``/``DataLoader``
          producers) across the run: each is logged and skipped, the
          budget-exceeding one re-raises."""
        self.bind([(d.name, d.shape) for d in train_data.provide_data],
                  [(d.name, d.shape) for d in train_data.provide_label],
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)
        _fit_loop(self, self._symbol, self._logger, train_data, eval_data,
                  eval_metric, num_epoch, batch_end_callback,
                  epoch_end_callback, prefetch=prefetch,
                  checkpoint_prefix=checkpoint_prefix, resume=resume,
                  bad_batch_budget=bad_batch_budget)

    def score(self, eval_data, eval_metric, num_batch=None):
        """ref: BaseModule.score."""
        self._check_bound()
        return _score_loop(self, eval_data, eval_metric, num_batch)

    def predict(self, eval_data, num_batch=None):
        """ref: BaseModule.predict — concatenated first-output batches."""
        self._check_bound()
        return _predict_loop(self, eval_data, num_batch)

    # ---------------------------------------------------------- checkpoint --
    def save_checkpoint(self, prefix, epoch):
        """ref: Module.save_checkpoint → prefix-symbol.json +
        prefix-NNNN.params."""
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)

    @classmethod
    def load(cls, prefix, epoch, data_names=("data",),
             label_names=("softmax_label",), context=None):
        symb, arg, aux = load_checkpoint(prefix, epoch)
        m = cls(symb, data_names=data_names, label_names=label_names,
                context=context)
        m._preloaded = (arg, aux)
        return m

    def bind_and_restore(self, data_shapes, label_shapes=None,
                         for_training=False):
        """Convenience for load(): bind then restore the checkpointed
        params (the reference does this inside Module.load + bind)."""
        self.bind(data_shapes, label_shapes, for_training=for_training)
        arg, aux = getattr(self, "_preloaded", (None, None))
        self.set_params(arg or {}, aux or {})


# ---------------------------------------------------------------------------
# the epoch / score / predict loops, shared by Module and BucketingModule
# (ref: BaseModule.fit/score/predict — both module kinds route through one
# loop; `mod` needs forward/backward/update/update_metric/get_outputs)
# ---------------------------------------------------------------------------

def _fit_loop(mod, symbol, logger, train_data, eval_data, eval_metric,
              num_epoch, batch_end_callback, epoch_end_callback, prefetch=0,
              checkpoint_prefix=None, resume=False, bad_batch_budget=0):
    if isinstance(eval_metric, str):
        eval_metric = _metric.create(eval_metric)
    base_iter = train_data
    wrapped = None

    def _wrap():
        nonlocal train_data, wrapped
        if prefetch:
            from .io import PrefetchingIter
            train_data = wrapped = PrefetchingIter(base_iter,
                                                   capacity=int(prefetch))

    _wrap()

    def _next_fn(src):
        # DataIter-style sources pull through .next() so the iterator's own
        # cursor survives a re-wrap after a bad batch; anything else (plain
        # iterables, generators) goes through the standard protocol, giving
        # the seed's `for batch in train_data` duck-typing back
        nx = getattr(src, "next", None)
        return nx if callable(nx) else iter(src).__next__

    # supervised runs (the launcher exports MXTPU_HEARTBEAT_DIR) stamp
    # a per-rank heartbeat every batch so the supervisor's watchdog can
    # tell a slow step from a hung one; unsupervised runs get None and
    # pay nothing.  The same env contract arms the flight recorder
    # (MXTPU_FLIGHT_DIR): the supervisor collects per-rank post-mortem
    # bundles next to its event log
    heartbeat = _elastic.Heartbeat.from_env()
    _telemetry.flight_from_env()

    start_epoch, skip_batches = 0, 0
    if resume:
        if not checkpoint_prefix:
            raise ValueError("fit(resume=True) needs checkpoint_prefix")
        pos = _load_fit_snapshot(mod, checkpoint_prefix, logger)
        if pos is not None:
            start_epoch, skip_batches = pos
    bad_batches = 0

    def _skip_bad(exc, epoch, nbatch, nxt):
        """Budgeted bad-batch handling, shared by the resume fast-forward
        and the main loop; returns the (possibly re-wrapped) puller."""
        nonlocal bad_batches
        if bad_batches >= bad_batch_budget:
            raise
        bad_batches += 1
        logger.warning(
            "Epoch[%d] Batch[%d] bad batch (%d of %d budgeted), "
            "skipping: %s", epoch, nbatch, bad_batches, bad_batch_budget,
            exc)
        if wrapped is not None and wrapped._exhausted:
            # the failed PrefetchingIter joined its producers and went
            # exhausted (thread hygiene); re-wrap the still-open base
            # iterator — its cursor is already past the bad batch, so
            # the epoch continues
            _wrap()
            return _next_fn(train_data)
        return nxt

    try:
        # the latch turns SIGTERM/SIGINT (preemption notice, ^C) into a
        # snapshot-then-clean-return at the next batch boundary instead of
        # a mid-update death (only armed when there is somewhere to save)
        with _fault.GracefulExit(
                enabled=checkpoint_prefix is not None) as gexit:
            for epoch in range(start_epoch, num_epoch):
                t0 = time.time()
                eval_metric.reset()
                train_data.reset()
                nxt = _next_fn(train_data)
                nbatch = 0
                while skip_batches > 0:
                    # mid-epoch resume: fast-forward past the batches the
                    # preempted run already trained on (deterministic
                    # iterators replay the same pulls — including the same
                    # bad batches, which trained nothing and are budgeted
                    # again here — and land on the exact same remainder)
                    try:
                        nxt()
                    except StopIteration:
                        break
                    except Exception as exc:
                        nxt = _skip_bad(exc, epoch, nbatch, nxt)
                        continue
                    skip_batches -= 1
                    nbatch += 1
                skip_batches = 0
                while True:
                    # per-step spans: one sampled trace per
                    # batch, feed (the nxt() pull — the input pipeline's
                    # wait) vs compute (fwd+bwd+update), mirrored into
                    # the Chrome-trace stream like request traces.  One
                    # ACTIVE check per batch when tracing is off.
                    t_feed0 = _telemetry.now_us() if _telemetry.ACTIVE \
                        else None
                    try:
                        batch = nxt()
                    except StopIteration:
                        break
                    except Exception as exc:
                        nxt = _skip_bad(exc, epoch, nbatch, nxt)
                        continue
                    t_comp0 = time.perf_counter()
                    mod.forward(batch, is_train=True)
                    mod.backward()
                    mod.update()
                    mod.update_metric(eval_metric, batch.label)
                    step_ms = (time.perf_counter() - t_comp0) * 1e3
                    if t_feed0 is not None:
                        tr = _telemetry.maybe_trace("step",
                                                    server="Module.fit",
                                                    t0=t_feed0)
                        if tr is not None:
                            now = _telemetry.now_us()
                            t_mid = now - step_ms * 1e3
                            tr.open("feed", parent=tr.root,
                                    t0=t_feed0).end(t_mid)
                            tr.open("compute", parent=tr.root,
                                    t0=t_mid).end(now)
                            tr.root.attrs["epoch"] = epoch
                            tr.root.attrs["nbatch"] = nbatch
                            tr.root.end(now)
                            tr.finish()
                    if batch_end_callback:
                        batch_end_callback(_callback.BatchEndParam(
                            epoch=epoch, nbatch=nbatch,
                            eval_metric=eval_metric))
                    nbatch += 1
                    if heartbeat is not None:
                        # stamp the OPTIMIZER's update count (restored by
                        # resume), not a from-zero batch counter: a
                        # resumed attempt must report its real position
                        # or the post-mortem progress reads near-zero
                        # while the checkpoint says step 10000
                        heartbeat.beat(
                            int(_opt_owner(mod)._optimizer.num_update),
                            phase="train", last_step_ms=step_ms)
                    if gexit.requested:
                        if heartbeat is not None:
                            heartbeat.beat(phase="snapshot")
                        _save_fit_snapshot(mod, symbol, checkpoint_prefix,
                                           epoch, nbatch)
                        # any in-flight AsyncSnapshotter writes commit
                        # BEFORE the process exits
                        _flush_async_checkpoints(logger)
                        logger.info(
                            "Epoch[%d] Batch[%d] caught signal %s: snapshot "
                            "saved under %r, exiting cleanly (resume with "
                            "fit(..., resume=True))", epoch, nbatch,
                            gexit.signum, checkpoint_prefix)
                        return
                name, val = eval_metric.get()
                logger.info("Epoch[%d] Train-%s=%f  time=%.1fs",
                            epoch, name, val, time.time() - t0)
                if eval_data is not None:
                    # the eval pass beats too (phase "eval"): a long
                    # validation sweep with no stamps would look exactly
                    # like a hang to the supervisor's watchdog
                    for name, val in _score_loop(mod, eval_data,
                                                 eval_metric,
                                                 heartbeat=heartbeat):
                        logger.info("Epoch[%d] Validation-%s=%f",
                                    epoch, name, val)
                if epoch_end_callback:
                    arg, aux = mod.get_params()
                    epoch_end_callback(epoch, symbol, arg, aux)
            if gexit.requested:
                # signal landed after the last batch (during eval /
                # epoch-end callbacks): every epoch DID finish, so this is
                # a completed run — fall through to clear the marker, but
                # say so instead of swallowing the signal silently
                logger.info("caught signal %s after the final batch; "
                            "training had already completed", gexit.signum)
    finally:
        if wrapped is not None:  # join producer threads deterministically
            wrapped.close()
    # only reached when every epoch ran (a preemption returns from inside
    # the try): drop the marker so a later fit(resume=True) does not rewind
    # into a stale spot (a crash mid-run keeps it — the snapshot is still
    # the best restart point)
    if checkpoint_prefix:
        _clear_fit_snapshot(checkpoint_prefix)


# ------------------------------------------------- preemption snapshots --
# The classic Module path's counterpart of parallel.CheckpointManager:
# params ride the 1.x artifact layout (symbol json + params file), optimizer
# state and the mid-epoch position ride beside it.  Each snapshot's payload
# files carry a unique epoch+batch stamp, every file goes through tmp +
# os.replace, and the json marker (which names the stamp) is written LAST —
# so a crash at any point, including a SIGKILL while RE-snapshotting after
# an earlier resume, leaves the marker referencing only one complete,
# mutually-consistent set: the old one or the new one, never a torn mix.
# Stale stamped sets are pruned after each marker commit.

def _flatten_opt_state(st, key, out):
    if st is None:
        return
    if isinstance(st, (tuple, list)):
        for i, s in enumerate(st):
            _flatten_opt_state(s, f"{key}.{i}", out)
    else:
        out[key] = st


def _assign_opt_state(st, key, payload):
    if st is None:
        return
    if isinstance(st, (tuple, list)):
        for i, s in enumerate(st):
            _assign_opt_state(s, f"{key}.{i}", payload)
    else:
        _assign(st, payload[key], key)


def _opt_owner(mod):
    """The module holding the (possibly shared) optimizer + state set —
    the default bucket for BucketingModule, the module itself otherwise."""
    return getattr(mod, "_default_module", mod)


def _replace_committed(write_fn, path):
    write_fn(path + ".tmp")
    os.replace(path + ".tmp", path)


def _prune_fit_snapshots(prefix, keep_stamp=None):
    """Remove stamped snapshot payloads except ``keep_stamp``'s set.

    Matches ONLY the exact stamp shape this module writes
    (``<prefix>-n####b######-…`` and its ``.tmp-…`` orphans) — a bare
    startswith would eat unrelated user files living next to the prefix
    (``model-notes.txt``, a ``do_checkpoint('model-new')`` artifact)."""
    import re
    d = os.path.dirname(prefix) or "."
    # {4,}/{6,}: the f"{epoch:04d}"/"{nbatch:06d}" stamp widths are
    # MINIMUMS — epoch 10000 / batch 1000000 widen the field, and a
    # fixed-width match would leave those snapshots unpruned forever
    pat = re.compile(re.escape(os.path.basename(prefix))
                     + r"-(n\d{4,}b\d{6,})[.-]")
    for name in os.listdir(d):
        m = pat.match(name)
        if m and m.group(1) != keep_stamp:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


def _flush_async_checkpoints(logger):
    """Drain any live ``AsyncSnapshotter`` before a SIGTERM exit: a
    snapshot the step loop believed saved must be ON DISK before the
    process dies — the elastic supervisor's progress accounting reads
    the directory, never the queue.  Best-effort: a flush failure must
    not turn a clean exit into a crash."""
    try:
        from .parallel.checkpoint import flush_pending
        if not flush_pending(timeout=60.0):
            logger.warning("async checkpoint flush timed out — a queued "
                           "snapshot may not have committed")
    except Exception as exc:    # noqa: BLE001 — exiting anyway
        logger.warning("async checkpoint flush failed: %s", exc)


def _save_fit_snapshot(mod, symbol, prefix, epoch, nbatch):
    arg, aux = mod.get_params()
    # unique per-snapshot stamp: a re-snapshot after a resume must never
    # overwrite files the still-committed old marker points at
    stamp = f"n{epoch:04d}b{nbatch:06d}"
    snap = f"{prefix}-{stamp}"
    # reuse the 1.x artifact writer, committed atomically: write the pair
    # under a tmp prefix, then os.replace each file into place
    tmp_prefix = snap + ".tmp"
    save_checkpoint(tmp_prefix, epoch, symbol, arg, aux)
    os.replace(f"{tmp_prefix}-symbol.json", f"{snap}-symbol.json")
    os.replace(f"{tmp_prefix}-{epoch:04d}.params",
               f"{snap}-{epoch:04d}.params")
    owner = _opt_owner(mod)
    states = {}
    for n, st in owner._opt_states.items():
        _flatten_opt_state(st, n, states)
    if states:
        _replace_committed(lambda p: nd.save(p, states),
                           f"{snap}-{epoch:04d}.optstate.params")
    opt = owner._optimizer
    marker = {"epoch": epoch, "nbatch": nbatch, "stamp": stamp,
              "num_update": int(opt.num_update),
              "index_update_count": {str(k): int(v) for k, v in
                                     opt._index_update_count.items()},
              "has_optstate": bool(states)}
    path = f"{prefix}-resume.json"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(marker, f)
    os.replace(tmp, path)
    _prune_fit_snapshots(prefix, keep_stamp=stamp)


def _load_fit_snapshot(mod, prefix, logger):
    """Restore a preemption snapshot; (epoch, completed_batches) to resume
    from, or None for a fresh start."""
    path = f"{prefix}-resume.json"
    if not os.path.exists(path):
        logger.info("fit(resume=True): no snapshot at %r, training from "
                    "scratch", path)
        return None
    with open(path) as f:
        marker = json.load(f)
    epoch = int(marker["epoch"])
    snap = f"{prefix}-{marker['stamp']}" if marker.get("stamp") else prefix
    _, arg, aux = load_checkpoint(snap, epoch)
    mod.set_params(arg, aux)
    owner = _opt_owner(mod)
    if marker.get("has_optstate"):
        payload = nd.load(f"{snap}-{epoch:04d}.optstate.params")
        for n, st in owner._opt_states.items():
            _assign_opt_state(st, n, payload)
    opt = owner._optimizer
    opt.num_update = int(marker["num_update"])
    opt._index_update_count.update(
        {int(k): int(v) for k, v in marker["index_update_count"].items()})
    logger.info("fit(resume=True): resuming at epoch %d, batch %d "
                "(num_update=%d)", epoch, marker["nbatch"],
                opt.num_update)
    return epoch, int(marker["nbatch"])


def _clear_fit_snapshot(prefix):
    try:
        os.remove(f"{prefix}-resume.json")
    except OSError:
        pass
    _prune_fit_snapshots(prefix)


def _close_feed(it):
    """Join a wrapped async feed's producer threads (PrefetchingIter /
    DevicePrefetcher / DataLoader expose ``close()``).  Only called on
    EARLY exit or error — a cleanly-exhausted iterator stays open so the
    caller can ``reset()`` and reuse it."""
    close = getattr(it, "close", None)
    if callable(close):
        try:
            close()
        except Exception:
            pass


def _redeliver_unclaimed(gexit):
    """An inference loop's latch caught a signal, cleanup is done, and
    the handlers are restored.  If an ENCLOSING latch also saw it (fit's
    preemption latch, a serving runtime's) the graceful path is theirs —
    return normally.  If nobody else asked for graceful handling,
    re-deliver the signal under the restored handlers: swallowing a
    SIGTERM here would leave a process its operator tried to kill
    training for another 99 epochs."""
    if gexit.requested and not gexit.forwarded:
        _signal.raise_signal(gexit.signum)


def _infer_loop(mod, eval_data, num_batch, on_batch, heartbeat=None):
    """The interrupt/cleanup scaffold score and predict share.  Both
    honor ``fault.GracefulExit`` (inside an armed latch — fit's, or a
    caller's — a SIGTERM/SIGINT stops at the next batch boundary with
    partial results; with no outer latch the signal is re-delivered after
    cleanup) and close a wrapped async feed on early exit or error, so an
    interrupted inference pass never leaks producer threads (``fit`` has
    the same hygiene; these are the inference paths).  ``on_batch``
    consumes each completed forward."""
    if callable(getattr(eval_data, "reset", None)):
        eval_data.reset()
    with _fault.GracefulExit() as gexit:
        try:
            for i, batch in enumerate(eval_data):
                if num_batch is not None and i >= num_batch:
                    break
                mod.forward(batch, is_train=False)
                on_batch(batch)
                if heartbeat is not None:
                    heartbeat.beat(phase="eval")
                if gexit.requested:
                    _close_feed(eval_data)
                    break
        except BaseException:
            _close_feed(eval_data)
            raise
    _redeliver_unclaimed(gexit)


def _score_loop(mod, eval_data, eval_metric, num_batch=None,
                heartbeat=None):
    if isinstance(eval_metric, str):
        eval_metric = _metric.create(eval_metric)
    eval_metric.reset()
    _infer_loop(mod, eval_data, num_batch,
                lambda batch: mod.update_metric(eval_metric, batch.label),
                heartbeat=heartbeat)
    return [eval_metric.get()]


def _predict_loop(mod, eval_data, num_batch=None):
    chunks = []
    _infer_loop(mod, eval_data, num_batch,
                lambda batch: chunks.append(mod.get_outputs()[0].asnumpy()))
    if not chunks:
        # no batch completed (empty iterator, or an outer-latched signal
        # before the first one): there is no output to infer a correct
        # shape/dtype from, and a fabricated (0,)-shaped float32 array
        # would crash callers later (preds[:, k]) instead of here
        raise ValueError("predict: no batches were processed — the data "
                         "iterator was empty or a signal stopped the pass "
                         "before the first batch completed")
    return nd.array(np.concatenate(chunks, axis=0))


class BucketingModule:
    """ref: mx.mod.BucketingModule — one Module per bucket (sequence
    length), every bucket ALIASING the default bucket's parameter/grad/aux
    arrays via ``Module.bind(shared_module=...)``, so a single optimizer
    trains them all.  ``sym_gen(bucket_key) -> (symbol, data_names,
    label_names)``; batches route by ``DataBatch.bucket_key``."""

    def __init__(self, sym_gen, default_bucket_key=None, context=None,
                 logger=None, capture=None):
        if default_bucket_key is None:
            raise ValueError("BucketingModule needs default_bucket_key")
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._ctx = context
        self._capture = capture
        self._logger = logger or logging.getLogger(__name__)
        self._buckets: Dict[object, Module] = {}
        self._curr: Optional[Module] = None
        self.binded = False
        self.for_training = False

    def _module_for(self, key):
        if key not in self._buckets:
            symb, dnames, lnames = self._sym_gen(key)
            self._buckets[key] = Module(symb, data_names=dnames,
                                        label_names=lnames,
                                        context=self._ctx,
                                        logger=self._logger,
                                        capture=self._capture)
        return self._buckets[key]

    @property
    def _default_module(self):
        return self._buckets[self._default_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, grad_req="write"):
        """Bind the DEFAULT bucket (it owns the shared arrays)."""
        if self.binded and not force_rebind:
            return
        m = self._module_for(self._default_key)
        m.bind(data_shapes, label_shapes, for_training=for_training,
               force_rebind=force_rebind, grad_req=grad_req)
        self._grad_req = grad_req     # every bucket binds with the same req
        self._curr = m
        self.binded = True
        self.for_training = for_training

    def _check_bound(self):
        if not self.binded:
            raise RuntimeError("BucketingModule: call bind() first")

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """ref: BucketingModule.switch_bucket — bind (sharing arrays with
        the default bucket) and make current."""
        self._check_bound()
        m = self._module_for(bucket_key)
        if not m.binded:
            extra = [n for n in m._param_names()
                     if n not in self._default_module._exec.arg_dict]
            if extra:
                # the reference asserts bucket args are a subset of the
                # default bucket's — a bucket-unique param would silently
                # stay at zeros and never train
                raise ValueError(
                    f"bucket {bucket_key!r} introduces parameters {extra} "
                    f"absent from the default bucket "
                    f"{self._default_key!r}; the default bucket must "
                    f"cover every parameter.  If these are auto-numbered "
                    f"names (lstm2_...), your sym_gen constructs NEW "
                    f"default-prefix cells per call — construct cells once "
                    f"outside sym_gen, or give them explicit prefixes")
            m.bind(data_shapes, label_shapes,
                   for_training=self.for_training,
                   grad_req=self._grad_req,
                   shared_module=self._default_module)
        self._share_optimizer(m)
        self._curr = m
        mon = getattr(self, "_monitor", None)
        if mon is not None and mon._exec is not m._exec:
            mon.install(m._exec)
        return m

    def _share_optimizer(self, m):
        """Every bucket updates through ONE optimizer + state set, with
        name-stable indices, so update() steps exactly the params whose
        grads the CURRENT bucket just wrote (stepping all default params
        would re-apply stale grads for subset buckets)."""
        d = self._default_module
        if d.optimizer_initialized and not m.optimizer_initialized:
            m._optimizer = d._optimizer
            m._opt_states = d._opt_states
            m._opt_index = d._opt_index
            m.optimizer_initialized = True

    # ---- delegation to the current bucket ----
    def init_params(self, *a, **kw):
        self._default_module.init_params(*a, **kw)
        for m in self._buckets.values():
            m.params_initialized = True

    def init_optimizer(self, *a, **kw):
        self._default_module.init_optimizer(*a, **kw)

    def forward(self, data_batch, is_train=None):
        self._check_bound()
        key = getattr(data_batch, "bucket_key", None)
        key = self._default_key if key is None else key
        shapes = [(n, tuple(d.shape)) for n, d in
                  zip(self._module_for(key)._data_names, data_batch.data)]
        lshapes = None
        if data_batch.label is not None:
            lshapes = [(n, tuple(d.shape)) for n, d in
                       zip(self._module_for(key)._label_names,
                           data_batch.label)]
        self.switch_bucket(key, shapes, lshapes)
        self._curr.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._check_bound()
        self._curr.backward(out_grads)

    def update(self):
        # through the CURRENT bucket: the shared optimizer/state set steps
        # exactly the params whose grads this bucket's backward wrote
        self._check_bound()
        self._curr.update()

    def get_outputs(self):
        self._check_bound()
        return self._curr.get_outputs()

    def update_metric(self, eval_metric, labels):
        self._curr.update_metric(eval_metric, labels)

    def get_params(self):
        self._check_bound()
        return self._default_module.get_params()

    def install_monitor(self, mon):
        """ref: BucketingModule.install_monitor — the monitor follows the
        current bucket's executor at every switch."""
        self._check_bound()
        self._monitor = mon
        for m in self._buckets.values():
            if m.binded:
                m._monitor = mon
        mon.install(self._curr._exec)

    def set_params(self, arg_params, aux_params, **kw):
        self._default_module.set_params(arg_params, aux_params, **kw)

    def score(self, eval_data, eval_metric, num_batch=None):
        return _score_loop(self, eval_data, eval_metric, num_batch)

    def predict(self, eval_data, num_batch=None):
        return _predict_loop(self, eval_data, num_batch)

    def _bind_from_iter(self, train_data, force_rebind):
        """Default-bucket shapes: provide_data when the iterator describes
        them (they describe the DEFAULT bucket, per the 1.x contract);
        otherwise the first batch, which must then BE the default bucket —
        binding the shared arrays from another bucket's shapes would
        allocate wrong-shaped weights for shape-dependent nets."""
        if getattr(train_data, "provide_data", None):
            self.bind([(d.name, tuple(d.shape))
                       for d in train_data.provide_data],
                      [(d.name, tuple(d.shape))
                       for d in train_data.provide_label]
                      if getattr(train_data, "provide_label", None) else None,
                      force_rebind=force_rebind)
            return
        first = next(iter(train_data))
        train_data.reset()
        key = getattr(first, "bucket_key", None)
        if key is not None and key != self._default_key:
            raise ValueError(
                f"BucketingModule.fit: the iterator has no provide_data and "
                f"its first batch is bucket {key!r}, not the default "
                f"{self._default_key!r}; give the iterator provide_data "
                f"describing the default bucket (or lead with a "
                f"default-bucket batch)")
        dm = self._module_for(self._default_key)
        self.bind([(n, tuple(d.shape)) for n, d in
                   zip(dm._data_names, first.data)],
                  [(n, tuple(d.shape)) for n, d in
                   zip(dm._label_names, first.label)]
                  if first.label is not None else None,
                  force_rebind=force_rebind)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, num_epoch=1, batch_end_callback=None,
            epoch_end_callback=None, force_rebind=False, force_init=False,
            prefetch=0, checkpoint_prefix=None, resume=False,
            bad_batch_budget=0):
        """ref: BaseModule.fit routed through switch_bucket — same
        signature as Module.fit (incl. the fault-tolerance knobs)."""
        self._bind_from_iter(train_data, force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)
        _fit_loop(self, self._default_module.symbol, self._logger,
                  train_data, eval_data, eval_metric, num_epoch,
                  batch_end_callback, epoch_end_callback, prefetch=prefetch,
                  checkpoint_prefix=checkpoint_prefix, resume=resume,
                  bad_batch_budget=bad_batch_budget)


# ---------------------------------------------------------------------------
# mx.model checkpoint helpers (ref: python/mxnet/model.py)
# ---------------------------------------------------------------------------

def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """ref: mx.model.save_checkpoint — symbol json + 'arg:'/'aux:'-prefixed
    param file, the 1.x artifact layout."""
    symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", payload)


def load_checkpoint(prefix, epoch):
    """ref: mx.model.load_checkpoint → (symbol, arg_params, aux_params)."""
    symb = _sym_load(f"{prefix}-symbol.json")
    payload = nd.load(f"{prefix}-{epoch:04d}.params")
    arg = {k[4:]: v for k, v in payload.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in payload.items() if k.startswith("aux:")}
    return symb, arg, aux
