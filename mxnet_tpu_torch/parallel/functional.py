"""Functional views of Gluon blocks (the port of
``mxnet_tpu/parallel/functional.py``).

``functional_call`` runs a block's forward with other tensors swapped in
for its parameters and reports which auxiliary parameters (BatchNorm
running statistics) the forward replaced — the state a training step
owns and writes back itself.
"""
from __future__ import annotations

from .. import autograd as _autograd

__all__ = ["param_names_and_values", "trainable_split", "functional_call"]


def param_names_and_values(block):
    """Sorted ``(names, Parameters, tensors)`` of the whole tree."""
    params = block.collect_params()
    names = sorted(params.keys())
    plist = [params[n] for n in names]
    return names, plist, [p.data() for p in plist]


def trainable_split(plist):
    """Indices of trainable vs auxiliary (``grad_req == "null"``)
    parameters."""
    train_idx = [i for i, p in enumerate(plist) if p.grad_req != "null"]
    aux_idx = [i for i, p in enumerate(plist) if p.grad_req == "null"]
    return train_idx, aux_idx


def functional_call(block, plist, tensors, inputs, training):
    """``block(*inputs)`` with ``tensors`` standing in for ``plist``'s
    data, in training mode or not.  Returns ``(out, mutated)`` where
    ``mutated`` lists ``(index, new_tensor)`` for each parameter the
    forward replaced; every parameter's own data is restored."""
    saved = [(p, p._data) for p in plist]
    prev_train = _autograd.set_training(training)
    try:
        for p, t in zip(plist, tensors):
            p._data = t
        out = block(*inputs)
        mutated = [(i, p._data) for i, (p, t) in enumerate(zip(plist,
                                                               tensors))
                   if p._data is not t]
    finally:
        for p, d in saved:
            p._data = d
        _autograd.set_training(prev_train)
    return out, mutated
