"""Gluon Trainer (the port of ``mxnet_tpu/gluon/trainer.py``).

A ``Trainer`` owns an optimizer and one state per trainable parameter.
``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients through the kvstore when there is more than one worker,
and applies the optimizer's eager ``update`` to each parameter.
``kvstore`` is a type name (``"device"``, ``"local"``, ``"dist_sync"``,
``"dist_sync_device"``, ...; ``kvstore.create``), a ``KVStore``, or
None.  One worker's gradients are already complete, so a store with one
worker is the identity and is skipped; with several workers
(``distributed.init``) each gradient is pushed and pulled back in place
(summed over the workers).  ``compression_params`` sets the store's
2-bit compression; ``update_on_kvstore=True`` hands the optimizer to the
store, which updates each weight server-side from the pushed gradient,
and the weight is pulled back.

A parameter with row_sparse gradients (``Embedding(sparse_grad=True)``)
hands an optimizer that ``supports_sparse`` (SGD, Adam, AdaGrad) its
row_sparse gradient, the lazy update; any other optimizer gets the
dense gradient buffer.  Under ``update_on_kvstore`` such a parameter
pushes its row_sparse gradient and pulls back only the touched rows
with one worker (``row_sparse_pull``), the whole weight with several
(other workers' rows moved too).
"""
from __future__ import annotations

from .. import optimizer as opt_mod
from ..ndarray.ndarray import NDArray

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
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
        self._kvstore = None
        self._update_on_kvstore = bool(update_on_kvstore)
        if kvstore is not None:
            if isinstance(kvstore, str):
                from .. import kvstore as kv_mod
                self._kvstore = kv_mod.create(kvstore)
            else:
                self._kvstore = kvstore  # a kvstore.KVStore
            if compression_params:
                self._kvstore.set_gradient_compression(compression_params)
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
        self._kv_initialized = False

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

    def _init_kvstore(self):
        if self._kvstore is not None and not self._kv_initialized:
            for i, p in enumerate(self._params):
                self._kvstore.init(i, p.data())
            self._kv_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``1 / batch_size``, reduce them over the
        workers and update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._kvstore is not None and (
                self._update_on_kvstore or self._kvstore.num_workers > 1):
            self._init_kvstore()       # one worker's local store is unused
        if self._kvstore is not None and self._update_on_kvstore:
            # the store applies the optimizer: push gradients, pull
            # weights (the local optimizer states stay unallocated)
            multi = self._kvstore.num_workers > 1
            sparse_ok = self._optimizer.supports_sparse
            for i, p in enumerate(self._params):
                if p._grad_stype == "row_sparse" and sparse_ok:
                    g = p.grad()  # the row_sparse view of the gradient
                    self._kvstore.push(i, g)
                    if multi:
                        # other workers' pushes moved rows outside ours
                        self._kvstore.pull(i, out=p.data())
                    else:
                        self._kvstore.row_sparse_pull(i, out=p.data(),
                                                      row_ids=g.indices)
                else:
                    self._kvstore.push(i, p._dense_grad())
                    self._kvstore.pull(i, out=p.data())
            return
        if not self._states_ready:
            self._init_states()
        if self._kvstore is not None and self._kvstore.num_workers > 1:
            self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum each gradient over the workers (for gradient-manipulation
        workflows; one worker: the gradients are already complete)."""
        self._init_kvstore()
        if self._kvstore is not None:
            self._allreduce_grads()

    def _allreduce_grads(self):
        # dense on the wire, pulled back into the gradient buffer itself;
        # a row_sparse view is re-derived from it at update time
        for i, p in enumerate(self._params):
            g = p._dense_grad()
            self._kvstore.push(i, g)
            self._kvstore.pull(i, out=g)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update only (gradients already reduced)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._states_ready:
            self._init_states()
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
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
