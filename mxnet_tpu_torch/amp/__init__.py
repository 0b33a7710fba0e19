"""``mx.amp`` — automatic mixed precision (the port of
``mxnet_tpu/amp/__init__.py``).

ref: python/mxnet/amp/amp.py — amp.init() (list-driven op-level cast
rewriting), amp.init_trainer() + amp.scale_loss() (dynamic loss scaling),
amp/lists/* (op categories).

The semantics of the declared dtype are the JAX package's: ``"float16"``
and ``"bfloat16"`` both compute in **bfloat16** (the exponent range of
f32); ``"float16"`` also installs the dynamic loss scaler (scale up
every ``scale_window`` clean steps, halve it and skip the update on
overflow), ``"bfloat16"`` none.

The cast policy (``lists``: a target op's float inputs cast down to the
target, an FP32 op's up to float32, a WIDEST op's mixed operands to the
widest) applies where ops enter the runtime, as the JAX package applies
it in its one dispatch point.  ``init()`` wraps each listed op's
function once; the wrapper casts the call's positional float tensors
and calls the op.  Two entry points use the wrappers:

- ``nd.invoke`` reads ``ndarray._AMP`` (one global read while AMP is
  off) and calls the wrapper of the name it was given;
- the op namespace ``F`` (``mxnet_tpu_torch.ops``, which
  ``hybrid_forward`` receives and the model zoo calls) holds the
  wrappers in place of the listed functions while AMP is on;
  ``_deinit_for_tests`` puts the functions back, so AMP off costs the
  namespace nothing.

Every cast is the registry's ``amp_cast``, on the autograd graph: an
f32 parameter cast down keeps its f32 gradient.  Call ``init()``
before a hybridized block's first call: a captured graph keeps the
policy it was captured under.

``LossScaler.has_overflow`` gives the JAX verdict (any non-finite
gradient) from one multi-tensor reduction over all gradients and one
host sync a step.  ``init_trainer`` wraps ``Trainer.step``: a skipped
step zeroes the gradients and leaves every parameter and optimizer
state as it was; a clean one folds the loss scale into the optimizer's
``rescale_grad``, so the gradients are unscaled exactly once.
"""
from __future__ import annotations

import contextlib
import sys

import torch

from ..base import dtype_name
from ..ndarray import ndarray as _nd_mod
from . import lists
from .quantize import Int8Quantizer, dequantize_weight, quantize_weight

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_model", "LossScaler",
           "Int8Quantizer", "quantize_weight", "dequantize_weight"]

_FLOATS = (torch.float16, torch.bfloat16, torch.float32)
# never wrapped (as the JAX policy skips them): the casts themselves
_SKIP = ("amp_cast", "amp_multicast", "Cast", "stop_gradient")


class _AmpState:
    def __init__(self, target_dtype):
        self.declared = str(target_dtype)
        # float16 requests compute in bfloat16 (amp_cast maps them; the
        # declared dtype decides whether the loss scaler is installed)
        self.target = torch.bfloat16
        self.target_ops = set(lists.TARGET_DTYPE_OPS)
        self.fp32_ops = set(lists.FP32_OPS)
        self.widest_ops = set(lists.WIDEST_OPS)


_state = None
_wrapped = {}            # op name -> the policy wrapper of its function


def _want(op_name, dtypes):
    """The dtype op ``op_name`` should see its float inputs in (given
    their dtypes), or None to leave them."""
    s = _state
    if op_name in s.target_ops:
        return s.target
    if op_name in s.fp32_ops:
        return torch.float32
    if op_name in s.widest_ops and len(set(dtypes)) > 1:
        return max(dtypes, key=lambda d: d.itemsize)
    return None


def _cast_tensors(op_name, args):
    """The policy on one call's positional tensors, each cast through
    the registry's ``amp_cast``."""
    dts = [a.dtype for a in args
           if isinstance(a, torch.Tensor) and a.dtype in _FLOATS]
    want = _want(op_name, dts) if dts else None
    if want is None:
        return args
    from ..ops.registry import OPS
    cast = OPS["amp_cast"]
    name = dtype_name(want)
    return tuple(
        cast(a, dtype=name)
        if isinstance(a, torch.Tensor) and a.dtype in _FLOATS
        and a.dtype != want else a
        for a in args)


def _policy_wrapper(op_name, fn):
    def wrapper(*args, **kwargs):
        return fn(*_cast_tensors(op_name, args), **kwargs)

    wrapper.__name__ = getattr(fn, "__name__", op_name)
    wrapper.__doc__ = fn.__doc__
    wrapper.__wrapped__ = fn
    return wrapper


def _install():
    """Wrap every listed op (once per name) and put the wrappers into
    the namespace ``F``."""
    from .. import ops
    s = _state
    for name in s.target_ops | s.fp32_ops | s.widest_ops:
        if name in _wrapped or name in _SKIP or name not in ops.OPS:
            continue
        _wrapped[name] = _policy_wrapper(name, ops.OPS[name])
        setattr(ops, name, _wrapped[name])


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP process-wide (ref: amp.init).  Idempotent."""
    global _state
    target_dtype = dtype_name(target_dtype)
    assert target_dtype in ("float16", "bfloat16")
    fresh = _state is None
    if fresh:
        _state = _AmpState(target_dtype)
    else:
        # re-init: keep previously registered custom lists, retarget dtype
        prev_t, prev_32 = _state.target_ops, _state.fp32_ops
        _state.__init__(target_dtype)
        _state.target_ops |= prev_t
        _state.fp32_ops |= prev_32
    if target_precision_ops:
        _state.target_ops.update(target_precision_ops)
    if fp32_ops:
        _state.fp32_ops.update(fp32_ops)
    if conditional_fp32_ops:
        # reference semantics: run these ops in fp32 when the named attr
        # matches; conservatively force fp32 always (safe direction)
        _state.fp32_ops.update(
            name if isinstance(name, str) else name[0]
            for name in conditional_fp32_ops)
    _install()
    if fresh:
        _nd_mod._AMP = sys.modules[__name__]


def _deinit_for_tests():
    """Undo init() (test isolation only; the reference has no amp.off)."""
    global _state
    if _state is None:
        return
    from .. import ops
    for name in _wrapped:
        setattr(ops, name, ops.OPS[name])
    _wrapped.clear()
    _nd_mod._AMP = None
    _state = None


class LossScaler:
    """Dynamic loss scaler (ref: amp/loss_scaler.py — class LossScaler)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient is non-finite: one multi-tensor reduction
        over every gradient (``x * 0`` is 0 where ``x`` is finite and NaN
        elsewhere) and one host sync."""
        grads = [g._data for g in (p.data().grad for p in params)
                 if g is not None]
        if not grads:
            return False
        zeros = torch.stack(torch._foreach_norm(
            torch._foreach_mul(grads, 0.0)))
        return not bool(torch.isfinite(zeros).all())

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0


def init_trainer(trainer):
    """Attach dynamic loss scaling to a gluon Trainer (ref: amp.init_trainer).

    bfloat16 targets skip scaling entirely (range matches f32)."""
    if _state is None:
        raise RuntimeError("call amp.init() before amp.init_trainer()")
    if _state.declared == "bfloat16":
        trainer._amp_loss_scaler = None
        return
    trainer._amp_loss_scaler = LossScaler()
    trainer._amp_original_step = trainer.step

    def _amp_step(batch_size, ignore_stale_grad=False, _t=trainer):
        scaler = _t._amp_loss_scaler
        overflow = scaler.has_overflow(_t._params)
        if overflow:
            scaler.update_scale(True)
            _t.zero_grad()
            return  # skip the update, like the reference
        # grads were produced under the CURRENT scale: unscale with it,
        # then let the scaler grow (growth applies to the NEXT backward)
        eff = 1.0 if getattr(_t, "_amp_unscaled", False) \
            else scaler.loss_scale
        _t._amp_unscaled = False
        _t._amp_original_step(batch_size * eff, ignore_stale_grad)
        scaler.update_scale(False)

    trainer.step = _amp_step


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as l: l.backward()``
    (ref: amp.scale_loss).  Scaling is folded into the rescale_grad of the
    trainer's next step, so gradients are unscaled exactly once."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Manually unscale accumulated grads (for gradient clipping between
    backward and step; ref: amp.unscale).  The scaler keeps its scale for
    the next iteration — only THIS step's grads are marked pre-unscaled."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        g = p.data().grad
        if g is not None:
            g._data = g._data * inv
    trainer._amp_unscaled = True


def convert_model(net, target_dtype="bfloat16"):
    """Cast a gluon block's parameters to the target dtype
    (ref: amp.convert_model for the symbolic path; gluon uses net.cast)."""
    net.cast(dtype_name(target_dtype))
    return net
