"""Optimizer updates for the training step (the port of
``mxnet_tpu/parallel/functional_opt.py``'s SGD rule).

The JAX functions are pure: ``(w, g, state) -> (w', state')``.  Here the
update writes **in place** into the step's tensors (called under
``torch.no_grad()``), with the same arithmetic in the same order.  For
half-precision weights the f32 master weight rides as the LAST state
element, as in the JAX step: the rule updates the master from the f32
gradient and the weight becomes the master cast back.
"""
from __future__ import annotations

import torch

__all__ = ["pure_update", "state_template"]


def _prep(opt, w, g, wd):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g + wd * w


def _sgd(opt, w, g, state, lr, wd):
    g = _prep(opt, w, g, wd)
    if opt.momentum == 0.0:
        w.sub_(lr * g)
        return
    (mom,) = state
    mom.mul_(opt.momentum).sub_(lr * g)
    w.add_(mom)


_DISPATCH = {"SGD": _sgd}


def _is_mp(opt, dtype):
    return bool(opt._mp_for(dtype))


def pure_update(opt, w, g, state, lr, wd):
    """Update ``w`` (and ``state``) in place from the gradient ``g``."""
    fn = _DISPATCH.get(type(opt).__name__)
    if fn is None:
        raise NotImplementedError(
            f"the port's train step has no update rule for "
            f"{type(opt).__name__} (ported: {sorted(_DISPATCH)})")
    if _is_mp(opt, w.dtype):
        master = state[-1]
        fn(opt, master, g.float(), state[:-1], lr, wd)
        w.copy_(master)
    else:
        fn(opt, w, g, state, lr, wd)


def state_template(opt, weight):
    """Zero state tuple for one weight: the momentum (when used), then
    the f32 master weight for half-precision weights."""
    mp = _is_mp(opt, weight.dtype)
    base = weight.detach().float() if mp else weight.detach()
    name = type(opt).__name__
    if name not in _DISPATCH:
        raise NotImplementedError(name)
    s = (torch.zeros_like(base),) if opt.momentum != 0.0 else ()
    return s + (base.clone(),) if mp else s
