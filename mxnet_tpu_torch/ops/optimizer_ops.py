"""Optimizer update ops (the port of ``mxnet_tpu/ops/optimizer_ops.py``).

Functional, as in the JAX package: each op returns the updated weight
(and updated states) and the caller writes them back
(``optimizer.Optimizer`` does, in place).  The arithmetic is the JAX
ops', in the same order.  ``parallel.TrainStep`` does not use these: it
runs ``parallel.functional_opt``'s multi-tensor rules.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = []


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight


@register_op("sgd_update")
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    return weight - lr * g


@register_op("sgd_mom_update")
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register_op("nag_mom_update")
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register_op("adam_update")
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * new_mean / (torch.sqrt(new_var) + epsilon),
            new_mean, new_var)


@register_op("adamw_update")
def _adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Decoupled weight decay."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    upd = new_mean / (torch.sqrt(new_var) + epsilon) + wd * weight
    return weight - eta * lr * upd, new_mean, new_var


@register_op("rmsprop_update")
def _rmsprop_update(weight, grad, n, lr=0.001, rho=0.9, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = rho * n + (1 - rho) * torch.square(g)
    out = weight - lr * g / (torch.sqrt(new_n) + epsilon)
    if clip_weights is not None and clip_weights > 0:
        out = torch.clamp(out, -clip_weights, clip_weights)
    return out, new_n


@register_op("rmspropalex_update")
def _rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001, rho=0.9,
                        momentum=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = rho * n + (1 - rho) * torch.square(g)
    new_g = rho * g_state + (1 - rho) * g
    new_delta = momentum * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return weight + new_delta, new_n, new_g, new_delta


@register_op("ftrl_update")
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register_op("signsgd_update")
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    return weight - lr * torch.sign(g)


@register_op("signum_update")
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom), new_mom


@register_op("adagrad_update")
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_h = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_h) + epsilon), new_h


@register_op("adadelta_update")
def _adadelta_update(weight, grad, acc_g, acc_delta, lr=1.0, rho=0.9,
                     epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(new_acc_g + epsilon) \
        * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - lr * delta, new_acc_g, new_acc_delta


@register_op("lamb_update_phase1")
def _lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                        epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m_hat, v_hat = new_mean, new_var
    if bias_correction:
        m_hat = new_mean / (1 - beta1 ** t)
        v_hat = new_var / (1 - beta2 ** t)
    update = m_hat / (torch.sqrt(v_hat) + epsilon) + wd * weight
    return update, new_mean, new_var


@register_op("lamb_update_phase2")
def _lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                        upper_bound=-1.0):
    """The trust ratio ``r1 / r2`` (1 where either is 0), ``r1`` clipped
    to the bounds that are > 0."""
    r1c = r1
    if lower_bound is not None and lower_bound > 0:
        r1c = torch.clamp_min(r1c, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1c = torch.clamp_max(r1c, upper_bound)
    ratio = torch.where((r1c > 0) & (r2 > 0), r1c / r2, torch.ones_like(r1c))
    return weight - lr * ratio * g_update


@register_op("mp_sgd_update")
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """Half-precision weight with an f32 master copy."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register_op("mp_sgd_mom_update")
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _per_weight(vals, n, name, op="multi_sgd_update"):
    """``lrs``/``wds``: a scalar for every weight or one per weight."""
    if vals is None:
        raise ValueError(f"{op} requires {name} (scalar or one per weight)")
    if isinstance(vals, (int, float)):
        return [vals] * n
    vals = list(vals)
    if len(vals) != n:
        raise ValueError(f"{name} has {len(vals)} entries for {n} weights")
    return vals


@register_op("multi_sgd_update")
def _multi_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                      clip_gradient=None, num_weights=None):
    """SGD over interleaved ``(weight_0, grad_0, weight_1, grad_1, ...)``;
    returns the updated weights in order."""
    n = num_weights if num_weights is not None else len(arrays) // 2
    lrs, wds = _per_weight(lrs, n, "lrs"), _per_weight(wds, n, "wds")
    outs = []
    for i in range(n):
        w, g = arrays[2 * i], arrays[2 * i + 1]
        g = _apply_wd(g.to(w.dtype), w, wds[i], rescale_grad, clip_gradient)
        outs.append(w - lrs[i] * g)
    return tuple(outs) if n > 1 else outs[0]


@register_op("multi_mp_sgd_update")
def _multi_mp_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                         clip_gradient=None, num_weights=None):
    """The f32-master form over interleaved ``(weight, grad, master)``
    triples; returns ``(weight', master')`` pairs flattened in order."""
    n = num_weights if num_weights is not None else len(arrays) // 3
    lrs = _per_weight(lrs, n, "lrs", "multi_mp_sgd_update")
    wds = _per_weight(wds, n, "wds", "multi_mp_sgd_update")
    outs = []
    for i in range(n):
        w, g, m = arrays[3 * i], arrays[3 * i + 1], arrays[3 * i + 2]
        g32 = _apply_wd(g.float(), m, wds[i], rescale_grad, clip_gradient)
        m_new = m - lrs[i] * g32
        outs += [m_new.to(w.dtype), m_new]
    return tuple(outs)
