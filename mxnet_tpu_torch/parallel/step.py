"""The training step (the port of ``mxnet_tpu/parallel/step.py``'s
``TrainStep``, on one device).

Usage, as with the JAX package::

    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", learning_rate=0.1,
                                               momentum=0.9, wd=1e-4))
    loss = step(x, y)          # forward, loss, backward, SGD update
    step.sync_params_to_net()  # the step's parameters into the net

``data`` and ``label`` may each be one tensor or a tuple/list of them
(``None`` leaves pass through): the net is called as ``net(*data)`` and
the loss as ``loss_fn(out, label)``, a one-element label tuple unwrapped
— e.g. BERT pretraining with ``data = (tokens, token_types, None,
masked_positions)`` and ``label = (mlm_labels, mlm_weights,
nsp_labels)``.

The step owns copies of the net's parameters (made at the first call).
Each call runs the forward in training mode, the loss averaged over the
batch (in f32), the backward, the optimizer update at step count
``t = num_update + 1`` from f32 master weights for half-precision
parameters (with each parameter's ``lr_mult``/``wd_mult``), and the
write-back of the BatchNorm running
statistics — what the JAX step's one compiled program does.  Here the
ops run eagerly on the net's device, and the update and the write-back
are **in place** on the step's tensors, under ``torch.no_grad()``.

``skip_nonfinite=True`` leaves parameters, optimizer state and running
statistics untouched when the loss or any gradient is not finite (one
host sync per step), and raises ``NonFiniteAbortError`` after
``nonfinite_budget`` consecutive skips.

Not ported yet: a device mesh (data parallelism), gradient compression,
batch donation and the prefetching feed.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _autograd
from .functional import (functional_call, param_names_and_values,
                         trainable_split)
from .functional_opt import pure_update, state_template

__all__ = ["TrainStep", "NonFiniteAbortError"]


class NonFiniteAbortError(RuntimeError):
    """Too many consecutive non-finite steps."""


class TrainStep:
    """``step(data, label)`` -> the loss, updating the step's params."""

    def __init__(self, net, loss_fn, optimizer, mesh=None,
                 skip_nonfinite=False, nonfinite_budget=10):
        if mesh is not None:
            raise NotImplementedError("the port's TrainStep runs on one "
                                      "device; a mesh is not ported yet")
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._skip_nonfinite = bool(skip_nonfinite)
        self._nonfinite_budget = nonfinite_budget
        self.skipped_steps = 0
        self.consecutive_skips = 0
        self._built = False
        self._num_update = optimizer.begin_num_update

    # --------------------------------------------------------------- build --
    def _device(self):
        for p in self.net.collect_params().values():
            if p._data is not None:
                return p._data.device
            if p._deferred_init is not None:
                return p._deferred_init[1]
        raise RuntimeError("TrainStep: the net has no initialized "
                           "parameters; call net.initialize() first")

    def _coerce(self, value):
        """A tensor (or numpy array) on the net's device; tuples and
        lists leaf by leaf, ``None`` as it is."""
        if value is None:
            return None
        if isinstance(value, (tuple, list)):
            return tuple(self._coerce(v) for v in value)
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"TrainStep takes torch tensors or numpy "
                            f"arrays, got {type(value).__name__}")
        return value.to(self._device())

    def _build(self, data_args):
        net = self.net
        if any(p._deferred_init is not None
               for p in net.collect_params().values()):
            # deferred shapes need only the feature dims: a batch-1 slice
            # of every tensor leaf
            with _autograd.pause():
                net(*(a if a is None else a[:1] for a in data_args))
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
        self._built = True

    def _base_lr(self):
        # at the post-increment count, as the JAX step evaluates it
        opt = self.optimizer
        if opt.lr_scheduler is not None:
            return float(opt.lr_scheduler(self._num_update + 1))
        return float(opt.lr)

    # ---------------------------------------------------------------- call --
    def __call__(self, data, label):
        return self.step(data, label)

    def step(self, data, label):
        data, label = self._coerce(data), self._coerce(label)
        data_args = data if isinstance(data, tuple) else (data,)
        if isinstance(label, tuple) and len(label) == 1:
            label = label[0]
        if not self._built:
            self._build(data_args)
        tensors = [None] * len(self._plist)
        for i, t in zip(self._train_idx, self._train):
            tensors[i] = t
        for i, t in zip(self._aux_idx, self._aux):
            tensors[i] = t
        with _autograd.record(train_mode=True):
            out, mutated = functional_call(self.net, self._plist, tensors,
                                           data_args, training=True)
            loss = self.loss_fn(out, label).mean().float()
        grads = torch.autograd.grad(loss, self._train)
        if self._skip_nonfinite and not self._all_finite(loss, grads):
            self._skip(loss)
            return loss.detach()
        lr, opt = self._base_lr(), self.optimizer
        t = self._num_update + 1
        with torch.no_grad():
            for k, (w, g, s) in enumerate(zip(self._train, grads,
                                              self._states)):
                pure_update(opt, w, g, s, t, lr * self._lr_mults[k],
                            opt.wd * self._wd_mults[k])
            for i, new in mutated:
                if i in self._aux_pos:
                    self._aux[self._aux_pos[i]] = new
        self._num_update += 1
        self.consecutive_skips = 0
        opt.num_update = self._num_update
        return loss.detach()

    @staticmethod
    def _all_finite(loss, grads):
        finite = torch.isfinite(loss).all()
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        return bool(finite)

    def _skip(self, loss):
        self.skipped_steps += 1
        self.consecutive_skips += 1
        budget = self._nonfinite_budget
        if budget is not None and self.consecutive_skips >= budget:
            raise NonFiniteAbortError(
                f"TrainStep: {self.consecutive_skips} consecutive non-finite "
                f"updates (budget {budget}) at num_update="
                f"{self._num_update}; last loss={float(loss.detach())}. "
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
