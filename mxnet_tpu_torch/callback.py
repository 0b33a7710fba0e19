"""Training callbacks (the port of ``mxnet_tpu/callback.py``; ref:
python/mxnet/callback.py — Speedometer, do_checkpoint, log_train_metric,
ProgressBar), and ``do_step_checkpoint``/``do_heartbeat`` for the
checkpoints and heartbeats of ``parallel.checkpoint`` and
``elastic``."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "do_step_checkpoint",
           "do_heartbeat", "log_train_metric", "ProgressBar"]


class BatchEndParam:
    """ref: mxnet.model.BatchEndParam (namedtuple in the reference)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class Speedometer:
    """Log samples/sec every ``frequent`` batches (ref: class Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "	".join(f"{n}={v:.6f}" for n, v in name_value)
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\t%s", param.epoch, count,
                                 speed, msg)
                else:
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving parameters (ref: callback.do_checkpoint).
    The callback receives (epoch, net_or_params, *rest); gluon blocks are
    saved via save_parameters, plain dicts via nd.save."""
    period = max(1, int(period))

    def _callback(epoch, net, *rest):
        if (epoch + 1) % period != 0:
            return
        if len(rest) == 2 and isinstance(rest[0], dict):
            # Module.fit's (epoch, symbol, arg_params, aux_params) form —
            # write the classic 1.x artifact pair
            from .module import save_checkpoint
            save_checkpoint(prefix, epoch + 1, net, rest[0], rest[1])
            logging.info("Saved checkpoint to \"%s-%04d.params\"",
                         prefix, epoch + 1)
            return
        fname = f"{prefix}-{epoch + 1:04d}.params"
        if hasattr(net, "save_parameters"):
            net.save_parameters(fname)
        else:
            from . import ndarray as nd
            nd.save(fname, net)
        logging.info("Saved checkpoint to \"%s\"", fname)

    return _callback


def do_step_checkpoint(manager):
    """Batch-end callback driving a ``parallel.CheckpointManager`` —
    ``save_every_n_steps`` for step-driven training loops: hand the
    manager here and every batch boundary calls ``maybe_save()``, which
    snapshots atomically whenever ``every_n_steps`` divides the step
    count."""

    def _callback(param):
        manager.maybe_save()

    return _callback


def do_heartbeat(heartbeat):
    """Batch-end callback driving an ``elastic.Heartbeat`` — the liveness
    twin of ``do_step_checkpoint``: every batch boundary stamps this
    rank's heartbeat file so an elastic supervisor's watchdog can tell a
    slow step from a hung worker.
    ``Module.fit`` arms this automatically when launched supervised
    (``MXTPU_HEARTBEAT_DIR`` set); the explicit form is for custom
    loops."""

    def _callback(param):
        heartbeat.beat(phase="train")

    return _callback


def log_train_metric(period, auto_reset=False):
    """ref: callback.log_train_metric."""

    def _callback(param):
        if param.nbatch % max(1, period) == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class ProgressBar:
    """ref: callback.ProgressBar — textual progress over total batches."""

    def __init__(self, total, length=80):
        self.total = max(1, total)
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        pct = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.length - filled)
        print(f"[{bar}] {pct}%", end="\r", flush=True)
