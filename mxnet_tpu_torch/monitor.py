"""`mx.monitor` — layer-output statistics for debugging training (the
port of ``mxnet_tpu/monitor.py``).

ref: python/mxnet/monitor.py — class Monitor installs output callbacks on
executors and prints a per-layer stat (default mean(|x|)) every
``interval`` batches; the classic NaN hunt is
``mod.install_monitor(mx.mon.Monitor(1)); mon.tic(); ...; mon.toc_print()``.

Mechanism: on the card the executor's step is one captured graph, so
there are no per-op callbacks to hook.  Instead ``toc`` evaluates the
symbol's internals (every node's output) through a second executor that
ALIASES the monitored executor's argument/aux arrays — same values, one
extra program, no instrumentation cost on the training step itself (the
reference's monitor slows every hooked forward instead).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Monitor"]


def _default_stat(x: np.ndarray) -> np.ndarray:
    return np.abs(x).mean()


class Monitor:
    """ref: monitor.Monitor(interval, stat_func, pattern, sort)."""

    def __init__(self, interval: int = 1, stat_func=None, pattern: str = ".*",
                 sort: bool = False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self._exec = None
        self._internals_exec = None

    # ---- wiring ----
    def install(self, executor):
        """Attach to a bound Executor (Module.install_monitor calls this)."""
        self._exec = executor
        self._internals_exec = None

    def tic(self):
        """Start collecting for this batch (ref: Monitor.tic)."""
        if self.step % self.interval == 0:
            self.activated = True
        self.step += 1

    def _ensure_internals(self):
        from .executor import Executor
        from .symbol import Group

        if self._internals_exec is None:
            internals = self._exec._symbol.get_internals()
            members = internals._outputs_list()
            self._names = [s.name for s in members]
            # alias the monitored executor's arrays: same values, no copies
            self._internals_exec = Executor(
                Group(members), self._exec._ctx, self._exec.arg_dict,
                None, "null", self._exec.aux_dict)
        else:
            # args may have been re-fed (data/label change each batch)
            self._internals_exec.arg_dict = self._exec.arg_dict
            self._internals_exec.aux_dict = self._exec.aux_dict

    def toc(self):
        """Collect (step, name, stat) for every internal output + every
        argument/aux array whose name matches the pattern."""
        if not self.activated or self._exec is None:
            return []
        self._ensure_internals()
        outs = self._internals_exec.forward(is_train=False)
        res = []
        for name, arr in zip(self._names, outs):
            if self.re.match(name):
                res.append((self.step, f"{name}_output",
                            self.stat_func(arr.asnumpy())))
        for name, arr in list(self._exec.arg_dict.items()) + \
                list(self._exec.aux_dict.items()):
            if self.re.match(name):
                res.append((self.step, name, self.stat_func(arr.asnumpy())))
        if self.sort:
            res.sort(key=lambda t: t[1])
        self.activated = False
        return res

    def toc_print(self):
        """ref: Monitor.toc_print."""
        for step, name, value in self.toc():
            print(f"Batch: {step:7d} {name:30s} {value}")
