"""Control-flow ops (the port of ``mxnet_tpu/ops/control_flow.py``; ref:
src/operator/control_flow.{h,cc} — foreach, while_loop, cond as
subgraph-executing ops).

The calling conventions are the JAX package's: NDArrays in and out (the
``mx.nd.contrib.foreach`` form, multi-output bodies included), or raw
tensors, which the bodies then see.

Eager, each op runs its Python body as it stands: ``foreach`` steps
over axis 0, and ``while_loop`` and ``cond`` read their predicate on
the host (one sync an iteration, or a call).

A captured graph (the body of a hybridized block or of a training step,
which the card captures, and any CUDA graph capture) cannot record a
branch that depends on data, so there the ops take the form that
``lax`` gives them in the JAX package:

- ``while_loop`` with ``max_iterations`` runs exactly that many body
  steps; each step's update is kept only while the predicate holds
  (``torch.where``), so the final values are those of the JAX
  package's ``lax.while_loop`` form.  Without ``max_iterations`` it
  raises;
- ``cond`` evaluates both branches and selects, so both must give the
  same shapes (as ``lax.cond`` requires).

Neither reads the device from the host there, so nothing leaves the
graph unnoticed.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["foreach", "while_loop", "cond"]


def _in_graph(tensors=()):
    """True where the ops must take their graph form: inside a
    hybridized block's or a training step's body, or a CUDA capture."""
    from ..parallel.functional import running_eagerly
    if running_eagerly():
        return True
    return any(t.is_cuda for t in tensors) and \
        torch.cuda.is_current_stream_capturing()


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _nd_types():
    from ..ndarray.ndarray import NDArray, _wrap
    return NDArray, _wrap


def _unwrap(x):
    NDArray, _ = _nd_types()
    return x._data if isinstance(x, NDArray) else x


def foreach(body, data, init_states):
    """ref: foreach op — scan ``body(x_t, states) -> (out_t, new_states)``
    over axis 0 of ``data`` (an array or a list of arrays); returns the
    outputs stacked on axis 0 and the final states."""
    NDArray, wrap = _nd_types()
    nd_mode = any(isinstance(x, NDArray)
                  for x in _leaves(data) + _leaves(init_states))
    xs = _map(_unwrap, data)
    states = _map(_unwrap, init_states)
    steps = _leaves(xs)[0].shape[0]
    outs = []
    for t in range(steps):
        x_t = _map(lambda a, t=t: a[t], xs)
        if nd_mode:
            out, new = body(_map(wrap, x_t), _map(wrap, states))
            out, states = _map(_unwrap, out), _map(_unwrap, new)
        else:
            out, states = body(x_t, states)
        outs.append(out)
    if isinstance(outs[0], (list, tuple)):
        stacked = type(outs[0])(torch.stack([o[i] for o in outs])
                                for i in range(len(outs[0])))
    else:
        stacked = torch.stack(outs)
    if nd_mode:
        return _map(wrap, stacked), _map(wrap, states)
    return stacked, states


def _pred(p):
    """A predicate as a 0-d bool tensor (NDArray comparisons give float
    0/1, the reference's semantics)."""
    p = _unwrap(p)
    if not isinstance(p, torch.Tensor):
        return torch.tensor(bool(p))
    return (p != 0).reshape(()) if p.dtype != torch.bool else p.reshape(())


def while_loop(cond, func, loop_vars, max_iterations=None):
    """ref: while_loop op — ``func(*vars) -> new vars`` while
    ``cond(*vars)`` holds, at most ``max_iterations`` times.  Returns
    the final loop variables (a list of NDArrays in the NDArray form)."""
    NDArray, wrap = _nd_types()
    nd_mode = any(isinstance(v, NDArray) for v in loop_vars)
    vs = [_unwrap(v) for v in loop_vars]

    def call(f, vals):
        out = f(*[wrap(v) for v in vals]) if nd_mode else f(*vals)
        return out

    def step(vals):
        out = call(func, vals)
        return [_unwrap(o) for o in (out if isinstance(out, (list, tuple))
                                     else [out])]

    if _in_graph(vs):
        if max_iterations is None:
            raise RuntimeError(
                "while_loop inside a captured graph (a hybridized block, a "
                "training step or a CUDA graph capture) needs "
                "max_iterations: a loop whose trip count the device decides "
                "cannot be recorded; give the bound and the loop runs that "
                "many masked steps")
        alive = None
        for _ in range(int(max_iterations)):
            p = _pred(call(cond, vs)).to(vs[0].device)
            alive = p if alive is None else alive & p
            new = step(vs)
            if len(new) != len(vs):
                raise ValueError(f"while_loop: func returned {len(new)} "
                                 f"values for {len(vs)} loop variables")
            vs = [torch.where(alive, n, v) for n, v in zip(new, vs)]
    else:
        i = 0
        while (max_iterations is None or i < max_iterations) and \
                bool(_pred(call(cond, vs))):
            vs = step(vs)
            i += 1
    if nd_mode:
        return [wrap(v) for v in vs]
    return tuple(vs)


def cond(pred, then_func, else_func, inputs=()):
    """ref: cond op — ``then_func(*inputs)`` if ``pred`` else
    ``else_func(*inputs)``."""
    NDArray, wrap = _nd_types()
    nd_mode = isinstance(pred, NDArray) or any(
        isinstance(x, NDArray) for x in inputs)
    xs = tuple(_unwrap(x) for x in inputs)
    p = _pred(pred)

    def run(f):
        out = f(*[wrap(x) for x in xs]) if nd_mode else f(*xs)
        return _map(_unwrap, out)

    if _in_graph([p, *[x for x in xs if isinstance(x, torch.Tensor)]]):
        a, b = run(then_func), run(else_func)
        la, lb = _leaves(a), _leaves(b)
        if len(la) != len(lb) or any(x.shape != y.shape
                                     for x, y in zip(la, lb)):
            raise ValueError(
                "cond inside a captured graph evaluates both branches and "
                "selects: they must return the same structure and shapes "
                f"(got {[tuple(x.shape) for x in la]} and "
                f"{[tuple(y.shape) for y in lb]})")
        it = iter(lb)
        out = _map(lambda x: torch.where(p.to(x.device), x, next(it)), a)
    else:
        out = run(then_func if bool(p) else else_func)
    return _map(wrap, out) if nd_mode else out


# registry placeholder of the Python-level API above
register_op("_foreach_marker", lambda x: x)
