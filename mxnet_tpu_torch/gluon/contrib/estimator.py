"""gluon.contrib.estimator — the high-level fit loop with event handlers
(the port of ``mxnet_tpu/gluon/contrib/estimator.py``).

ref: python/mxnet/gluon/contrib/estimator/estimator.py — class Estimator
(fit/evaluate over DataLoaders, metric bookkeeping) and
event_handler.py — the TrainBegin/EpochEnd/... handler protocol with
LoggingHandler, CheckpointHandler, EarlyStoppingHandler.

The event order and the ``batches=`` argument are the JAX package's.
Each batch updates the training loss and metrics, which read their
values back to the host (``metric``): a sync a batch, the loop's cost
beside a hand-written loop that reads nothing.  Under
``amp.init("float16")`` + ``amp.init_trainer`` the loop calls
``trainer.step`` without ``amp.scale_loss``, as the JAX package does,
so the step divides unscaled gradients by the loss scale (ROADMAP,
queue C); the port keeps that behaviour.
"""
from __future__ import annotations

import copy
import logging
import os
import time

from ... import autograd
from ... import metric as _metric
from .. import loss as _loss
from ..trainer import Trainer

__all__ = ["Estimator", "EventHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler", "StopTraining"]

_LOGGER = "mxnet_tpu_torch.estimator"


class StopTraining(Exception):
    """Raised by handlers to end fit() early (ref: event_handler.py)."""


class EventHandler:
    """ref: the (Train|Epoch|Batch)(Begin|End) mixin protocol."""

    def train_begin(self, estimator):
        pass

    def train_end(self, estimator):
        pass

    def epoch_begin(self, estimator):
        pass

    def epoch_end(self, estimator):
        pass

    def batch_begin(self, estimator):
        pass

    def batch_end(self, estimator):
        pass


class LoggingHandler(EventHandler):
    """Per-epoch (and optional per-N-batch) metric logging
    (ref: LoggingHandler)."""

    def __init__(self, log_interval="epoch", logger=None):
        self.log_interval = log_interval
        self.logger = logger or logging.getLogger(_LOGGER)

    def train_begin(self, est):
        self._t0 = time.time()
        self.logger.info("Training begin")

    def train_end(self, est):
        self.logger.info("Training end: %.1fs total", time.time() - self._t0)

    def epoch_begin(self, est):
        self._e0 = time.time()

    def epoch_end(self, est):
        parts = [f"{name}={val:.4f}" for name, val in est.metric_values()]
        self.logger.info("epoch %d: %s (%.1fs)", est.current_epoch,
                         " ".join(parts), time.time() - self._e0)

    def batch_end(self, est):
        if self.log_interval != "epoch" and \
                est.current_batch % int(self.log_interval) == 0:
            parts = [f"{n}={v:.4f}" for n, v in est.metric_values()]
            self.logger.info("epoch %d batch %d: %s", est.current_epoch,
                             est.current_batch, " ".join(parts))


class CheckpointHandler(EventHandler):
    """Save params every epoch; optionally keep the best by a monitored
    metric (ref: CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", save_best=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.mode = mode
        self.save_best = save_best
        self.best = None
        os.makedirs(model_dir, exist_ok=True)

    def train_begin(self, est):
        self.best = None  # a reused handler must not carry a prior run's best

    def epoch_end(self, est):
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-{est.current_epoch:04d}"
                            f".params")
        est.net.save_parameters(path)
        if self.save_best and self.monitor:
            val = dict(est.metric_values()).get(self.monitor)
            if val is None:
                return
            better = (self.best is None
                      or (self.mode == "min" and val < self.best)
                      or (self.mode == "max" and val > self.best))
            if better:
                self.best = val
                est.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(EventHandler):
    """Stop when a monitored metric stops improving
    (ref: EarlyStoppingHandler)."""

    def __init__(self, monitor, mode="min", patience=2, min_delta=0.0):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.bad_epochs = 0

    def train_begin(self, est):
        # a reused handler restarts fresh for each fit()
        self.best = None
        self.bad_epochs = 0

    def epoch_end(self, est):
        val = dict(est.metric_values()).get(self.monitor)
        if val is None:
            return
        improved = (self.best is None
                    or (self.mode == "min"
                        and val < self.best - self.min_delta)
                    or (self.mode == "max"
                        and val > self.best + self.min_delta))
        if improved:
            self.best = val
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                raise StopTraining(
                    f"{self.monitor} has not improved for "
                    f"{self.bad_epochs} epochs (best {self.best})")


class Estimator:
    """ref: class Estimator — net + loss + metrics + trainer, driven by
    fit()/evaluate() with the handler protocol above."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 val_metrics=None):
        self.net = net
        if not isinstance(loss, _loss.Loss):
            raise ValueError(
                f"loss must be a gluon.loss.Loss, got {type(loss).__name__} "
                f"(ref: Estimator._check_loss)")
        self.loss = loss
        self.train_metrics = train_metrics or [_metric.Accuracy()]
        if val_metrics is None:
            # deepcopy keeps constructor configuration (top_k, axis, …)
            val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
            for m in val_metrics:
                m.reset()
        self.val_metrics = val_metrics
        self.trainer = trainer or Trainer(net.collect_params(), "adam")
        self.current_epoch = 0
        self.current_batch = 0
        self._val_loss = _metric.Loss("val_loss")
        self._train_loss = _metric.Loss("train_loss")

    # --- introspection used by handlers --------------------------------
    def metric_values(self):
        out = []
        for m in [self._train_loss] + self.train_metrics:
            name, val = m.get()
            out.append((name, val))
        for m in [self._val_loss] + self.val_metrics:
            name, val = m.get()
            if val == val:  # skip NaN (never updated)
                out.append((f"val_{name}" if not name.startswith("val")
                            else name, val))
        return out

    # --- the loops -----------------------------------------------------
    def _split_batch(self, batch):
        data, label = batch[0], batch[1]
        return data, label

    def evaluate(self, val_data):
        for m in [self._val_loss] + self.val_metrics:
            m.reset()
        for batch in val_data:
            data, label = self._split_batch(batch)
            out = self.net(data)
            loss = self.loss(out, label)
            self._val_loss.update(None, [loss])
            for m in self.val_metrics:
                m.update([label], [out])
        return [m.get() for m in self.val_metrics]

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batches=None):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())

        def fire(event):
            # every handler runs even if one raises StopTraining (the
            # stopping epoch must still log + checkpoint); the stop is
            # re-raised after the loop
            stop = None
            for h in handlers:
                try:
                    getattr(h, event)(self)
                except StopTraining as s:
                    stop = s
            if stop is not None:
                raise stop

        fire("train_begin")
        try:
            for epoch in range(epochs):
                self.current_epoch = epoch
                for m in [self._train_loss] + self.train_metrics:
                    m.reset()
                fire("epoch_begin")
                for i, batch in enumerate(train_data):
                    if batches is not None and i >= batches:
                        break
                    self.current_batch = i
                    fire("batch_begin")
                    data, label = self._split_batch(batch)
                    bs = data.shape[0] if hasattr(data, "shape") \
                        else len(data)
                    with autograd.record():
                        out = self.net(data)
                        loss = self.loss(out, label)
                    loss.backward()
                    self.trainer.step(bs)
                    self._train_loss.update(None, [loss])
                    for m in self.train_metrics:
                        m.update([label], [out])
                    fire("batch_end")
                if val_data is not None:
                    self.evaluate(val_data)
                fire("epoch_end")
        except StopTraining as stop:
            logging.getLogger(_LOGGER).info("%s", stop)
        fire("train_end")
        return self
