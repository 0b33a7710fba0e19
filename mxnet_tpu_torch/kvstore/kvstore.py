"""KVStore implementation (the port of ``mxnet_tpu/kvstore/kvstore.py``).

Values live where they were given (the card in a run on the card); a
pull writes into its output in place, so a parameter or gradient buffer
keeps its tensor (a captured graph or a hybridized block that holds it
stays valid).  In a distributed store (``dist_*``, more than one
worker) a push is summed over the workers: ``distributed.all_sum``, or
with 2-bit compression the packed codes all-gathered (4 values a byte,
16x fewer bytes than f32) and every peer's decoded into the sum; the
wire format and the sums are the JAX package's, bit for bit.
"""
from __future__ import annotations

import torch

from .. import distributed as _dist
from ..ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_KNOWN_TYPES = ("local", "device", "nccl", "dist_sync", "dist_async",
                "dist_sync_device", "dist_async_device", "horovod", "byteps")


def create(name="local"):
    """ref: kvstore.cc — KVStore::Create."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    base = name.lower()
    if base not in _KNOWN_TYPES:
        raise ValueError(f"unknown KVStore type '{name}'")
    if base in ("horovod", "byteps"):
        raise NotImplementedError(
            f"KVStore type '{base}' is an external-integration escape hatch "
            "in the reference; the port's multi-process path is the dist_* "
            "types over torch.distributed (mxnet_tpu_torch.distributed)")
    if base.startswith("dist_") and _dist.num_workers() == 1:
        raise RuntimeError(
            f"KVStore type '{base}' needs a multi-process run: initialize "
            "with mxnet_tpu_torch.distributed.init() (or launch via "
            "python -m mxnet_tpu_torch.launch) so num_workers() > 1; for "
            "single-process use 'device'")
    return KVStore(base)


def _as_list(v):
    return v if isinstance(v, (list, tuple)) else [v]


def _tensor_of(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    import numpy as np
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _quant_2bit(grad, residual, threshold):
    """ref: gradient_compression.cc — 2-bit quantization with error
    feedback: values beyond +-threshold become +-threshold, the rest 0;
    the quantization error accumulates in the residual."""
    acc = grad + residual
    thr = torch.full((), threshold, dtype=acc.dtype, device=acc.device)
    q = torch.where(acc >= thr, thr,
                    torch.where(acc <= -thr, -thr, torch.zeros_like(acc)))
    return q, acc - q


def _pack_2bit(q):
    """The 2-bit wire format: 4 values a byte; codes 0 -> 0, +t -> 1,
    -t -> 2 (ref: gradient_compression.cc Quantize2Bit)."""
    flat = q.reshape(-1)
    pad = (-flat.numel()) % 4
    codes = torch.where(flat > 0, 1, torch.where(flat < 0, 2, 0)) \
        .to(torch.uint8)
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    c = codes.reshape(-1, 4)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def _unpack_sum_2bit(gathered, threshold, shape, dtype):
    """Decode every peer's packed payload (``(P, nbytes)`` uint8) and sum
    them."""
    n = 1
    for s in shape:
        n *= s
    b = gathered
    codes = torch.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                        dim=-1).reshape(b.shape[0], -1)[:, :n]
    thr = torch.full((), threshold, dtype=dtype, device=b.device)
    vals = torch.where(codes == 1, thr,
                       torch.where(codes == 2, -thr, torch.zeros_like(thr)))
    return vals.sum(dim=0).to(dtype).reshape(shape)


class KVStore:
    """ref: class KVStoreLocal / KVStoreDist.

    Each key holds one array.  Pushing a list of values merges them by
    summation (CommDevice::Reduce); in a distributed store each worker's
    merged push is then summed over the workers."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._opt_states = {}
        self._compression = None   # (type, threshold)
        self._residuals = {}
        self._key_index = {}       # key -> dense optimizer index

    # -------------------------------------------------------------- basics --
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return _dist.rank()

    @property
    def num_workers(self):
        return _dist.num_workers()

    @property
    def _is_dist(self):
        return self._type.startswith("dist_") and _dist.num_workers() > 1

    def init(self, key, value):
        """ref: KVStore::Init — one-time per-key allocation; in a
        distributed store rank 0's value is broadcast so every worker
        starts identically."""
        for k, v in zip(_as_list(key), _as_list(value)):
            k = str(k)
            if k in self._store:
                continue
            arr = _tensor_of(v).detach().clone()
            if self._is_dist:
                _dist.broadcast_(arr, root=0)
            self._store[k] = NDArray(arr)

    # ---------------------------------------------------------------- push --
    def push(self, key, value, priority=0):
        """ref: KVStore::Push — merge pushed values into the store; with an
        optimizer attached (update_on_kvstore), run the update
        server-side.  row_sparse values take the lazy path: only pushed
        rows are merged and updated."""
        from ..sparse import RowSparseNDArray
        keys, vals = self._key_value_lists(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise KeyError(f"key '{k}' was not init()ed")
            if all(isinstance(v, RowSparseNDArray) for v in vlist):
                self._push_rsp(k, vlist)
                continue
            # mixed dense+rsp lists ride the dense wire
            arrs = [v.tostype("default")._data
                    if isinstance(v, RowSparseNDArray) else _tensor_of(v)
                    for v in vlist]
            merged = arrs[0].detach()
            for a in arrs[1:]:
                merged = merged + a.to(merged.device)
            if self._compression is not None:
                thr = self._compression[1]
                res = self._residuals.get(k)
                if res is None:
                    res = torch.zeros_like(merged)
                merged, res = _quant_2bit(merged, res, thr)
                self._residuals[k] = res
            if self._is_dist:
                if self._compression is not None:
                    thr = self._compression[1]
                    gathered = _dist.all_gather(_pack_2bit(merged))
                    merged = _unpack_sum_2bit(gathered, thr,
                                              tuple(merged.shape),
                                              merged.dtype)
                else:
                    merged = _dist.all_sum(merged)
            stored = self._store[k]
            if self._optimizer is not None:
                self._server_update(k, stored, NDArray(merged))
            elif self._updater is not None:
                self._updater(k, NDArray(merged), stored)
            else:
                # a copy: the merged value may be the pushed buffer itself
                _store_value(stored, merged)

    def _server_update(self, k, stored, grad):
        """Apply the attached optimizer server-side: digit keys keep their
        value as the optimizer index; string keys get negative indices,
        a namespace no digit key can collide with."""
        idx = self._key_index.setdefault(
            k, int(k) if k.isdigit() else -(len(self._key_index) + 1))
        if k not in self._opt_states:
            self._opt_states[k] = \
                self._optimizer.create_state_multi_precision(idx, stored)
        self._optimizer.update_multi_precision(
            idx, stored, grad, self._opt_states[k])

    def _push_rsp(self, k, vlist):
        """row_sparse push: union-merge pushed row sets, then lazy-update
        or store only those rows."""
        from .. import sparse as _sp
        if self._compression is not None:
            raise ValueError(
                "gradient compression does not support row_sparse push "
                "(the reference restricts 2bit to dense too)")
        merged = vlist[0]
        for v in vlist[1:]:
            merged = _sp.add(merged, v)
        if self._is_dist:
            # row sets differ per worker: the reduce rides the dense wire
            dense = _dist.all_sum(merged.tostype("default")._data)
            merged = _sp.cast_storage(NDArray(dense), "row_sparse")
        stored = self._store[k]
        if self._optimizer is not None:
            self._server_update(k, stored, merged)
        elif self._updater is not None:
            self._updater(k, merged, stored)
        else:
            # merge only the pushed rows
            stored._data[merged._indices.long()] = \
                merged._data.to(stored._data.dtype)

    # ---------------------------------------------------------------- pull --
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """ref: KVStore::Pull (into ``out`` in place)."""
        keys = [str(k) for k in _as_list(key)]
        results = []
        for k in keys:
            if k not in self._store:
                raise KeyError(f"key '{k}' was not init()ed")
            results.append(self._store[k])
        if out is not None:
            outs = _as_list(out)
            # each key's value into its output(s): either 1:1, or an
            # equal number of device-replica outputs per key
            if len(outs) % len(results) != 0:
                raise ValueError(
                    f"pull: {len(outs)} outputs for {len(results)} keys")
            per_key = len(outs) // len(results)
            for i, o in enumerate(outs):
                src = results[i // per_key]._data
                with torch.no_grad():
                    o._data.copy_(src)
            return None
        return results if len(results) > 1 else results[0]

    def pushpull(self, key, value, out=None, priority=0):
        """ref: KVStore::PushPull (the dist_sync_device fast path)."""
        from ..sparse import RowSparseNDArray
        if out is None and any(isinstance(v, RowSparseNDArray)
                               for v in _as_list(value)):
            raise ValueError(
                "pushpull with a row_sparse value needs an explicit dense "
                "out= (a dense pull cannot land in sparse storage); or use "
                "push + row_sparse_pull(row_ids=...)")
        self.push(key, value, priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows as row_sparse (ref:
        KVStoreLocal::PullRowSparse).  Without row_ids the pull is
        dense."""
        from ..sparse import RowSparseNDArray
        if row_ids is None:
            return self.pull(key, out=out, priority=priority)
        keys = [str(k) for k in _as_list(key)]
        rids = _as_list(row_ids)
        if len(rids) == 1 and len(keys) > 1:
            rids = rids * len(keys)
        if len(rids) != len(keys):
            raise ValueError(
                f"row_sparse_pull: {len(rids)} row_id lists for "
                f"{len(keys)} keys")
        results = []
        for k, rid in zip(keys, rids):
            if k not in self._store:
                raise KeyError(f"key '{k}' was not init()ed")
            stored = self._store[k]
            ridx = torch.unique(_tensor_of(rid).to(
                stored._data.device, torch.int64))
            results.append(RowSparseNDArray(
                stored._data[ridx], ridx.to(torch.int32),
                tuple(stored.shape)))
        if out is not None:
            outs = _as_list(out)
            if len(outs) % len(results) != 0:
                raise ValueError(
                    f"row_sparse_pull: {len(outs)} outputs for "
                    f"{len(results)} keys")
            per_key = len(outs) // len(results)
            for i, o in enumerate(outs):
                r = results[i // per_key]
                if isinstance(o, RowSparseNDArray):
                    o._data, o._indices = r._data, r._indices
                    o.shape = r.shape
                else:  # dense target: overwrite just the pulled rows
                    with torch.no_grad():
                        o._data[r._indices.long()] = \
                            r._data.to(o._data.dtype)
            return None
        return results if len(results) > 1 else results[0]

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    # ----------------------------------------------------------- optimizer --
    def set_optimizer(self, optimizer):
        """ref: KVStore::SetOptimizer -> server-side updates."""
        self._optimizer = optimizer

    def is_capable(self, capability):
        return {"optimizer": True}.get(capability, False)

    def _set_updater(self, updater):
        """ref: KVStore::set_updater — updater fn(key, recv, stored)."""
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """ref: KVStore::SetGradientCompression — {'type': '2bit',
        'threshold': t}."""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise ValueError(f"unsupported compression '{ctype}'")
        thr = float(compression_params.get("threshold", 0.5))
        self._compression = (ctype, thr)

    # ------------------------------------------------------------ plumbing --
    def _key_value_lists(self, key, value):
        keys = [str(k) for k in _as_list(key)]
        if len(keys) == 1:
            return keys, [_as_list(value)]
        return keys, [_as_list(v) for v in _as_list(value)]

    def save_optimizer_states(self, fname, dump_optimizer=False):
        from .. import ndarray as nd
        d = {}
        for k, st in self._opt_states.items():
            for j, arr in enumerate(_flatten(st)):
                d[f"{k}.{j}"] = arr
        nd.save(fname, d)

    def load_optimizer_states(self, fname):
        from .. import ndarray as nd
        loaded = nd.load(fname, ctx="cpu")
        for k, st in self._opt_states.items():
            for j, arr in enumerate(_flatten(st)):
                kk = f"{k}.{j}"
                if kk in loaded:
                    arr._data.copy_(loaded[kk]._data)

    def __repr__(self):
        return f"KVStore(type={self._type}, keys={len(self._store)})"


def _store_value(stored, value):
    """``value`` into a stored NDArray: in place when the shape holds."""
    value = value.to(stored._data.device, stored._data.dtype)
    if tuple(value.shape) == tuple(stored._data.shape):
        stored._data.copy_(value)
    else:
        stored._data = value.clone()


def _flatten(state):
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    out = []
    for s in state:
        out.extend(_flatten(s))
    return out
