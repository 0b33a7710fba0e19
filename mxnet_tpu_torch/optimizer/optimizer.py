"""Optimizers (the port of ``mxnet_tpu/optimizer/optimizer.py``):
``Optimizer``, ``SGD``, ``NAG``, ``Adam``, ``AdamW``, ``Adamax``,
``Nadam``, ``LAMB``, ``LARS``, ``RMSProp``, ``AdaGrad``, ``AdaDelta``,
``Ftrl``, ``Signum``, ``SGLD``, ``register`` and ``create``.

An optimizer holds the hyperparameters and the multi-precision rule,
and two ways to apply them:

- eagerly, on NDArrays: ``update(index, weight, grad, state)`` (what
  ``gluon.Trainer`` calls) runs the registered update op
  (``ops/optimizer_ops.py``) and writes the results into the weight and
  state arrays in place;
- fused, in ``parallel.TrainStep``, which runs
  ``parallel.functional_opt``'s multi-tensor rules (those of the JAX
  step: SGD, NAG, Adam, AdamW, LAMB, LARS, RMSProp, AdaGrad, Signum).

``multi_precision=None`` (the default) keeps f32 master weights for
float16/bfloat16 parameters, as in the JAX package.

``supports_sparse`` is true on SGD, Adam and AdaGrad: their ``update``
takes a ``sparse.RowSparseNDArray`` gradient through the lazy update
(only its rows change, written into the weight in place); another
optimizer given one raises, and ``gluon.Trainer`` hands it the dense
gradient instead.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import dtype_torch
from ..ndarray.ndarray import NDArray, invoke

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "Adamax", "Nadam",
           "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "Signum", "SGLD",
           "LAMB", "LARS", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (``"sgd"``), or the instance."""
    if isinstance(name, Optimizer):
        return name
    n = name.lower()
    if n not in _REGISTRY:
        raise ValueError(f"unknown optimizer '{name}' (the port has "
                         f"{sorted(_REGISTRY)})")
    return _REGISTRY[n](**kwargs)


def _writeback(outs, *targets):
    """Write an update op's results into the live arrays, in place (so
    a parameter keeps its tensor)."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    with torch.no_grad():
        for t, o in zip(targets, outs):
            t._data.copy_(o._data)


def _zeros(weight):
    return NDArray(torch.zeros_like(weight._data.detach()))


def _assign(target, value):
    """Write ``value`` into the live array ``target``, in place."""
    with torch.no_grad():
        target._data.copy_(value)


def _is_rsp(grad):
    """True for a row_sparse gradient (the lazy-update dispatch)."""
    from ..sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray)


def _write_rows(weight, idx_rows):
    """Write a lazy update's rows into the weight's own tensor."""
    idx, rows = idx_rows
    with torch.no_grad():
        weight._data.index_copy_(0, idx, rows.to(weight._data.dtype))


class Optimizer:
    """Base optimizer: learning rate (or schedule), weight decay,
    gradient rescale/clip, per-parameter ``lr_mult``/``wd_mult``, update
    counts and the multi-precision rule."""

    supports_sparse = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=None, param_dict=None,
                 **_unused):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and getattr(lr_scheduler, "base_lr",
                                                None):
            self.lr = lr_scheduler.base_lr
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self._index_update_count = {}
        self.lr_mult = {}
        self.wd_mult = {}

    # ------------------------------------------------------------- plumbing --
    def _mp_for(self, dtype):
        """True when a parameter of ``dtype`` gets an f32 master weight:
        automatic for half precision while ``multi_precision`` is None."""
        low = dtype_torch(dtype) in (torch.float16, torch.bfloat16)
        return low if self.multi_precision is None \
            else (self.multi_precision and low)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """The state, with an f32 master copy first for a half-precision
        weight."""
        if self._mp_for(weight._data.dtype):
            master = weight.astype("float32")
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        p = self.param_dict.get(index)
        if p is not None:
            return lr * p.lr_mult
        return lr * self.lr_mult.get(index, self.lr_mult.get(
            self.idx2name.get(index, ""), 1.0))

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        if p is not None:
            return self.wd * p.wd_mult
        return self.wd * self.wd_mult.get(index, self.wd_mult.get(
            self.idx2name.get(index, ""), 1.0))

    def _kw(self, index, **extra):
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad, **extra)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    # -------------------------------------------------------------- update --
    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """``update``; for a half-precision weight with an f32 master in
        its state, update the master from the f32 gradient and write the
        weight as the master cast back."""
        if isinstance(state, tuple) and state and \
                isinstance(state[0], NDArray) and \
                state[0]._data.dtype == torch.float32 and \
                weight._data.dtype != torch.float32 and \
                self._mp_for(weight._data.dtype):
            master, sub = state
            self.update(index, master, grad.astype("float32"), sub)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``mom = momentum*mom - lr*(g + wd*w)``,
    ``w += mom``."""

    supports_sparse = True

    def __init__(self, momentum=0.0, lazy_update=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kw(index)
        if _is_rsp(grad):
            from .. import sparse
            args = (self._get_lr(index), self._get_wd(index),
                    self.rescale_grad, self.clip_gradient)
            if self.momentum == 0.0:
                _write_rows(weight, sparse._sgd_rows(weight, grad, *args))
            else:
                lr, wd, rescale, clip = args
                _write_rows(weight, sparse._sgd_mom_rows(
                    weight, grad, state, lr, self.momentum, wd, rescale,
                    clip))
            return
        if self.momentum == 0.0:
            _writeback(invoke("sgd_update", weight, grad, **kw), weight)
        else:
            _writeback(invoke("sgd_mom_update", weight, grad, state,
                              momentum=self.momentum, **kw), weight, state)


@register
class NAG(SGD):
    """Nesterov momentum (``nag_mom_update``)."""

    supports_sparse = False

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _writeback(invoke("nag_mom_update", weight, grad, state,
                          momentum=self.momentum, **self._kw(index)),
                   weight, state)


@register
class Adam(Optimizer):
    """Adam, the bias correction folded into the step size."""

    supports_sparse = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _lr_t(self, index):
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        return self._get_lr(index) * math.sqrt(coef2) / coef1

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        if _is_rsp(grad):
            from .. import sparse
            _write_rows(weight, sparse._adam_rows(
                weight, grad, mean, var, self._index_update_count[index],
                self._get_lr(index), self.beta1, self.beta2, self.epsilon,
                self._get_wd(index), self.rescale_grad, self.clip_gradient))
            return
        kw = self._kw(index, beta1=self.beta1, beta2=self.beta2,
                      epsilon=self.epsilon)
        kw["lr"] = self._lr_t(index)
        _writeback(invoke("adam_update", weight, grad, mean, var, **kw),
                   weight, mean, var)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (``adamw_update``)."""

    supports_sparse = False

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        kw = self._kw(index, beta1=self.beta1, beta2=self.beta2,
                      epsilon=self.epsilon, eta=1.0)
        kw["lr"] = self._lr_t(index)
        _writeback(invoke("adamw_update", weight, grad, mean, var, **kw),
                   weight, mean, var)


@register
class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(beta2 * u, |g|)``, the
    step ``lr / (1 - beta1**t) * m / (u + 1e-8)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr / (1.0 - self.beta1 ** t)
        m, u = state
        w = weight._data.detach()
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        _assign(m, self.beta1 * m._data + (1 - self.beta1) * g)
        _assign(u, torch.maximum(self.beta2 * u._data, g.abs()))
        _assign(weight, w - lr_t * m._data / (u._data + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule of Dozat
    (``schedule_decay``); the schedule's running product is the
    optimizer's, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data.detach()
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        _assign(m, self.beta1 * m._data + (1.0 - self.beta1) * g)
        _assign(v, self.beta2 * v._data + (1.0 - self.beta2) * g * g)
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = m._data / (1.0 - m_schedule_next)
        v_prime = v._data / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        _assign(weight, w - lr * m_bar / (torch.sqrt(v_prime)
                                          + self.epsilon))


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centred (``rmsprop_update``,
    ``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.momentum = momentum
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kw(index, rho=self.rho, epsilon=self.epsilon)
        if self.centered:
            n, g, delta = state
            _writeback(invoke("rmspropalex_update", weight, grad, n, g,
                              delta, momentum=self.momentum, **kw),
                       weight, n, g, delta)
        else:
            (n,) = state
            _writeback(invoke("rmsprop_update", weight, grad, n, **kw),
                       weight, n)


@register
class AdaGrad(Optimizer):
    """AdaGrad (``adagrad_update``)."""

    supports_sparse = True

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        if _is_rsp(grad):
            from .. import sparse
            _write_rows(weight, sparse._adagrad_rows(
                weight, grad, state, self._get_lr(index),
                self.float_stable_eps, self._get_wd(index),
                self.rescale_grad, self.clip_gradient))
            return
        _writeback(invoke("adagrad_update", weight, grad, state,
                          **self._kw(index, epsilon=self.float_stable_eps)),
                   weight, state)


@register
class AdaDelta(Optimizer):
    """AdaDelta (``adadelta_update``); no learning rate."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_delta = state
        kw = self._kw(index, rho=self.rho, epsilon=self.epsilon)
        del kw["lr"]
        _writeback(invoke("adadelta_update", weight, grad, acc_g, acc_delta,
                          **kw), weight, acc_g, acc_delta)


@register
class Ftrl(Optimizer):
    """Follow the regularised leader (``ftrl_update``)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _writeback(invoke("ftrl_update", weight, grad, z, n,
                          **self._kw(index, lamda1=self.lamda1,
                                     beta=self.beta)), weight, z, n)


@register
class Signum(Optimizer):
    """signSGD, or with ``momentum`` Signum (``signsgd_update``,
    ``signum_update``); ``wd_lh`` decays the weight by ``lr * wd_lh``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kw(index)
        if state is not None:
            _writeback(invoke("signum_update", weight, grad, state,
                              momentum=self.momentum, wd_lh=self.wd_lh,
                              **kw), weight, state)
        else:
            _writeback(invoke("signsgd_update", weight, grad, **kw), weight)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w - lr / 2 * g +
    sqrt(lr) * noise``, the standard normal noise drawn from the
    weight's device stream (``random.generator``)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data.detach()
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        noise = torch.randn(w.shape, generator=_random.generator(w.device),
                            device=w.device).to(w.dtype)
        _assign(weight, w - lr / 2 * g + math.sqrt(lr) * noise)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the step scaled by the trust
    ratio ``eta * ||w|| / (||g|| + wd * ||w|| + epsilon)`` (1 where a
    norm is 0), with optional momentum."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data.detach()
        g = grad._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        w_norm = torch.linalg.vector_norm(w.float())
        g_norm = torch.linalg.vector_norm(g.float())
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                            self.eta * w_norm / (g_norm + wd * w_norm
                                                 + self.epsilon),
                            torch.ones_like(w_norm))
        g = g + wd * w
        if state is not None:
            _assign(state, self.momentum * state._data + trust * lr * g)
            _assign(weight, w - state._data)
        else:
            _assign(weight, w - trust * lr * g)


@register
class LAMB(Optimizer):
    """LAMB, the BERT optimizer: Adam moments with bias correction at the
    step count, the update ``m_hat / (sqrt(v_hat) + eps) + wd * w``
    scaled by the trust ratio ``||w|| / ||update||`` (1 where either
    norm is 0), ``||w||`` optionally clipped to
    ``[lower_bound, upper_bound]``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        kw1 = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                   t=self._index_update_count[index],
                   bias_correction=self.bias_correction,
                   wd=self._get_wd(index), rescale_grad=self.rescale_grad)
        if self.clip_gradient is not None:
            kw1["clip_gradient"] = self.clip_gradient
        g, new_mean, new_var = invoke("lamb_update_phase1", weight, grad,
                                      mean, var, **kw1)
        _writeback((new_mean, new_var), mean, var)
        kw2 = dict(lr=self._get_lr(index))
        if self.lower_bound is not None:
            kw2["lower_bound"] = self.lower_bound
        if self.upper_bound is not None:
            kw2["upper_bound"] = self.upper_bound
        _writeback(invoke("lamb_update_phase2", weight, g, weight.norm(),
                          g.norm(), **kw2), weight)
