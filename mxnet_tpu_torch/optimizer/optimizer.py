"""Optimizers (the port of ``mxnet_tpu/optimizer/optimizer.py``'s
``Optimizer``, ``SGD``, ``LAMB`` and ``create``).

An optimizer here holds the hyperparameters and the multi-precision
rule; ``parallel.TrainStep`` applies the update
(``parallel.functional_opt``).  ``multi_precision=None`` (the default)
keeps f32 master weights for float16/bfloat16 parameters, as in the JAX
package.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch

__all__ = ["Optimizer", "SGD", "LAMB", "create", "register"]

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


class Optimizer:
    """Base optimizer: learning rate (or schedule), weight decay,
    gradient rescale/clip and the multi-precision rule."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, begin_num_update=0,
                 multi_precision=None):
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

    def _mp_for(self, dtype):
        """True when a parameter of ``dtype`` gets an f32 master weight:
        automatic for half precision while ``multi_precision`` is None."""
        low = dtype_torch(dtype) in (torch.float16, torch.bfloat16)
        return low if self.multi_precision is None \
            else (self.multi_precision and low)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``mom = momentum*mom - lr*(g + wd*w)``,
    ``w += mom``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum


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
