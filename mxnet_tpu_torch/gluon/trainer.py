"""Gluon Trainer (the port of ``mxnet_tpu/gluon/trainer.py``) on one
card.

A ``Trainer`` owns an optimizer and one state per trainable parameter.
``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and
applies the optimizer's eager ``update`` to each parameter from the
gradient the last backward left.  One card has one worker, so the
``"device"`` and ``"local"`` stores (and None) are the identity and
gradients are used where they are; a distributed store, a store object
and ``update_on_kvstore`` raise ``NotImplementedError`` (they come with
the multi-card port).

A parameter with row_sparse gradients (``Embedding(sparse_grad=True)``)
hands an optimizer that ``supports_sparse`` (SGD, Adam, AdaGrad) its
row_sparse gradient, the lazy update; any other optimizer gets the
dense gradient buffer.
"""
from __future__ import annotations

from .. import optimizer as opt_mod
from ..ndarray.ndarray import NDArray

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")


class Trainer:
    """Applies an optimizer to a set of parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if kvstore not in _LOCAL_STORES or update_on_kvstore or \
                compression_params:
            raise NotImplementedError(
                f"kvstore={kvstore!r} (update_on_kvstore="
                f"{update_on_kvstore}, compression {compression_params}): "
                f"the port's Trainer runs on one card with a local store "
                f"('device', 'local' or None)")
        if hasattr(params, "values"):
            params = list(params.values())
        self._params = [p for p in params if p.grad_req != "null"]
        self._scale = 1.0
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **(optimizer_params or {}))
        self._states = [None] * len(self._params)
        self._states_ready = False

    def _init_states(self):
        for i, p in enumerate(self._params):
            if self._states[i] is None:
                self._states[i] = self._optimizer \
                    .create_state_multi_precision(i, p.data())
        self._states_ready = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``1 / batch_size`` and update."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """One worker: the gradients are already complete."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._states_ready:
            self._init_states()
        sparse_ok = self._optimizer.supports_sparse
        for i, p in enumerate(self._params):
            g = p.grad() if sparse_ok or p._grad_stype != "row_sparse" \
                else p._dense_grad()
            self._optimizer.update_multi_precision(i, p.data(), g,
                                                   self._states[i])

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    # ---------------------------------------------------------- checkpoints --
    def save_states(self, fname):
        """The optimizer states (key ``"i.j"``: state j of parameter i)
        and the update count, in ``nd.save``'s container."""
        from .. import ndarray as nd
        d = {}
        for i, s in enumerate(self._states):
            for j, arr in enumerate(_flatten_state(s)):
                d[f"{i}.{j}"] = arr
        d["__meta__num_update"] = nd.array([self._optimizer.num_update],
                                           ctx="cpu")
        nd.save(fname, d)

    def load_states(self, fname):
        """States written by ``save_states`` (either package's)."""
        from .. import ndarray as nd
        loaded = nd.load(fname, ctx="cpu")
        if not self._states_ready:
            self._init_states()
        n_expected = sum(len(_flatten_state(s)) for s in self._states)
        n_loaded = sum(1 for k in loaded if not k.startswith("__meta__"))
        if n_loaded != n_expected:
            raise ValueError(
                f"optimizer state layout mismatch loading '{fname}': file "
                f"has {n_loaded} state arrays, current setup expects "
                f"{n_expected} (optimizer type or multi_precision setting "
                f"changed?)")
        for i, s in enumerate(self._states):
            for j, arr in enumerate(_flatten_state(s)):
                key = f"{i}.{j}"
                if key not in loaded:
                    raise ValueError(
                        f"optimizer state '{key}' missing in '{fname}'")
                if loaded[key].shape != arr.shape:
                    raise ValueError(
                        f"optimizer state '{key}' shape mismatch loading "
                        f"'{fname}': {loaded[key].shape} vs {arr.shape}")
                arr._data.copy_(loaded[key]._data)
        if "__meta__num_update" in loaded:
            n = int(loaded["__meta__num_update"].asnumpy()[0])
            self._optimizer.num_update = n
            for i in range(len(self._params)):
                self._optimizer._index_update_count[i] = n


def _flatten_state(state):
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    out = []
    for s in state:
        out.extend(_flatten_state(s))
    return out
