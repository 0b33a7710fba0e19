"""Optimizer updates for the training step (the port of
``mxnet_tpu/parallel/functional_opt.py``'s SGD and LAMB rules).

The JAX functions are pure: ``(w, g, state, t) -> (w', state')``.  Here
the update writes **in place** into the step's tensors (called under
``torch.no_grad()``), with the same arithmetic in the same order; ``t``
is the 1-based step count (LAMB's bias correction reads it).  For
half-precision weights the f32 master weight rides as the LAST state
element, as in the JAX step: the rule updates the master from the f32
gradient and the weight becomes the master cast back.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pure_update", "state_template"]


def _prep(opt, w, g, wd):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g + wd * w


def _sgd(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    if opt.momentum == 0.0:
        w.sub_(lr * g)
        return
    (mom,) = state
    mom.mul_(opt.momentum).sub_(lr * g)
    w.add_(mom)


def _bias_correction(beta, t):
    """``1 - beta**t`` as the JAX rule takes it: the power in f32."""
    return 1.0 - float(np.float32(beta) ** np.float32(t))


def _lamb(opt, w, g, state, t, lr, wd):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    m, v = state
    m.mul_(opt.beta1).add_((1 - opt.beta1) * g)
    v.mul_(opt.beta2).add_((1 - opt.beta2) * g * g)
    if opt.bias_correction:
        m_hat = m / _bias_correction(opt.beta1, t)
        v_hat = v / _bias_correction(opt.beta2, t)
    else:
        m_hat, v_hat = m, v
    upd = m_hat / (torch.sqrt(v_hat) + opt.epsilon) + wd * w
    r1 = torch.linalg.vector_norm(w.float())
    if opt.lower_bound is not None:
        r1 = r1.clamp_min(opt.lower_bound)
    if opt.upper_bound is not None:
        r1 = r1.clamp_max(opt.upper_bound)
    r2 = torch.linalg.vector_norm(upd.float())
    trust = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    w.sub_(lr * trust * upd.to(w.dtype))


_DISPATCH = {"SGD": _sgd, "LAMB": _lamb}


def _is_mp(opt, dtype):
    return bool(opt._mp_for(dtype))


def pure_update(opt, w, g, state, t, lr, wd):
    """Update ``w`` (and ``state``) in place from the gradient ``g`` at
    step ``t`` (1-based)."""
    fn = _DISPATCH.get(type(opt).__name__)
    if fn is None:
        raise NotImplementedError(
            f"the port's train step has no update rule for "
            f"{type(opt).__name__} (ported: {sorted(_DISPATCH)})")
    if _is_mp(opt, w.dtype):
        master = state[-1]
        fn(opt, master, g.float(), state[:-1], t, lr, wd)
        w.copy_(master)
    else:
        fn(opt, w, g, state, t, lr, wd)


def state_template(opt, weight):
    """Zero state tuple for one weight: SGD's momentum (when used) or
    the Adam family's (m, v), then the f32 master weight for
    half-precision weights."""
    mp = _is_mp(opt, weight.dtype)
    base = weight.detach().float() if mp else weight.detach()
    name = type(opt).__name__
    if name == "SGD":
        s = (torch.zeros_like(base),) if opt.momentum != 0.0 else ()
    elif name in ("Adam", "AdamW", "LAMB"):
        s = (torch.zeros_like(base), torch.zeros_like(base))
    else:
        raise NotImplementedError(name)
    return s + (base.clone(),) if mp else s
