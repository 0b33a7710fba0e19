"""Post-training int8 weight quantization for serving (the port of
``mxnet_tpu/amp/quantize.py``).

The lever is the **weight buffer**: int8 payloads + per-channel f32
scales quarter the bytes a served program holds and reads per batch.

The scheme is symmetric per-channel PTQ with deterministic
round-to-nearest-even (``torch.round`` rounds half to even, as
``jnp.round`` does), so payloads and scales equal the JAX package's bit
for bit:

- ``quantize_weight`` / ``dequantize_weight``: one f32 scale per output
  channel (``amax / 127`` along ``axis``), int8 payload.
- ``Int8Quantizer``: the serving-container form.  ``quantize()`` maps a
  params container (list or dict, the ``serving.HotSwapApply``
  currency) into its int8 representation — every float leaf with
  ``ndim >= min_ndim`` becomes a payload/scale *pair* of leaves
  (``k`` + ``k::scale`` for dicts, adjacent entries for sequences);
  1-D leaves (bias, norm stats) stay full precision.  ``wrap()`` turns
  an ``fn(params, *batch_leaves)`` into the int8-consuming form with
  the **dequantization inside**: give it to ``graphs.captured`` and the
  captured graph's weight inputs are the int8 payloads and f32 scales.

Leaves are numpy arrays (a two-byte ``V2`` leaf, how the port's
checkpoints hold bfloat16, is read as bfloat16) or torch tensors; the
results are torch tensors on the leaf's device.  ``quantize()`` is
deterministic and shape/dtype-stable, so it is also a fleet's
snapshot-ingest transform: ``WeightUpdater`` runs an f32 training
snapshot through it before ``validate_params``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray.ndarray import tensor_from_numpy

__all__ = ["quantize_weight", "dequantize_weight", "Int8Quantizer"]

#: dict-container key suffix pairing a scale leaf with its payload
SCALE_SUFFIX = "::scale"


def _tensor(leaf):
    """``leaf`` as a torch tensor: a numpy leaf as ``jnp.asarray`` takes
    it (64-bit types narrowed, a ``V2`` leaf as bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return tensor_from_numpy(np.asarray(leaf))


def _channel_view(scales, ndim, axis):
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return scales.reshape(shape)


def quantize_weight(w, axis=0):
    """Symmetric per-channel int8 quantization of one weight.

    Returns ``(q, scales)``: ``q`` int8 with ``w``'s shape, ``scales``
    f32 of shape ``(w.shape[axis],)`` (``amax / 127`` per channel; an
    all-zero channel gets scale 1 so dequantization is exact).
    Deterministic round-to-nearest-even."""
    x = _tensor(w).to(torch.float32)
    reduce_dims = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    amax = torch.amax(torch.abs(x), dim=reduce_dims)
    # != 0, not > 0: a NaN channel keeps its NaN scale, so the quantized
    # leaf dequantizes non-finite and the fleet's validate_params
    # all-finite gate rejects the snapshot
    scales = torch.where(amax != 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(x / _channel_view(scales, x.dim(), axis))
    # NaN payloads become 0, as the JAX package's int8 conversion makes them
    q = torch.nan_to_num(torch.clamp(q, -127.0, 127.0), nan=0.0)
    return q.to(torch.int8), scales


def dequantize_weight(q, scales, axis=0, dtype=torch.float32):
    """Inverse of ``quantize_weight`` (graph-safe: this is the fold-in a
    captured serving apply runs per batch)."""
    q = _tensor(q)
    return (q.to(torch.float32)
            * _channel_view(_tensor(scales), q.dim(), axis)).to(dtype)


def _is_quantized_payload(leaf):
    return getattr(leaf, "dtype", None) in (torch.int8, np.int8)


class Int8Quantizer:
    """Container-level int8 PTQ for serving params (see module doc).

    ``axis`` is the per-channel scale axis of the quantized weights —
    0 for MXNet-layout ``(units, in_units)`` Dense kernels, the last
    axis for ``x @ w`` math-layout kernels.  Leaves with fewer than
    ``min_ndim`` dims (or non-float dtypes) pass through unquantized
    (as tensors).
    """

    def __init__(self, axis=0, min_ndim=2):
        self.axis = int(axis)
        self.min_ndim = int(min_ndim)

    def _quantizes(self, leaf):
        t = _tensor(leaf)
        return t.is_floating_point() and t.dim() >= self.min_ndim

    def quantize(self, params):
        """f32 container → int8 container (payload/scale leaf pairs).

        Deterministic, so re-quantizing the same snapshot always yields
        the same leaves — the property ``validate_params`` relies on
        when a rolling update re-ingests f32 training snapshots."""
        if isinstance(params, dict):
            out = {}
            for k, v in params.items():
                if str(k).endswith(SCALE_SUFFIX) or _is_quantized_payload(v):
                    raise ValueError(
                        f"Int8Quantizer.quantize: leaf {k!r} already "
                        f"looks quantized — quantize() ingests "
                        f"full-precision containers only")
                if self._quantizes(v):
                    q, s = quantize_weight(v, self.axis)
                    out[k] = q
                    out[f"{k}{SCALE_SUFFIX}"] = s
                else:
                    out[k] = _tensor(v)
            return out
        out = []
        for v in params:
            if _is_quantized_payload(v):
                raise ValueError(
                    "Int8Quantizer.quantize: int8 leaf in input — "
                    "quantize() ingests full-precision containers only")
            if self._quantizes(v):
                q, s = quantize_weight(v, self.axis)
                out.extend((q, s))
            else:
                out.append(_tensor(v))
        return out

    def dequantize(self, qparams, dtype=torch.float32):
        """int8 container → full-precision container in the ORIGINAL
        layout (payload/scale pairs collapse back to one leaf).
        Graph-safe — ``wrap`` runs it inside the captured apply."""
        if isinstance(qparams, dict):
            out = {}
            for k, v in qparams.items():
                if str(k).endswith(SCALE_SUFFIX):
                    continue
                if _is_quantized_payload(v):
                    out[k] = dequantize_weight(
                        v, qparams[f"{k}{SCALE_SUFFIX}"], self.axis, dtype)
                else:
                    out[k] = v
            return out
        out, i = [], 0
        while i < len(qparams):
            v = qparams[i]
            if _is_quantized_payload(v):
                out.append(dequantize_weight(v, qparams[i + 1], self.axis,
                                             dtype))
                i += 2
            else:
                out.append(v)
                i += 1
        return out

    def wrap(self, fn, dtype=torch.float32):
        """``fn(params, *leaves)`` → ``qfn(qparams, *leaves)`` with the
        dequantization folded in.  ``graphs.captured(wrap(fn))`` captures
        graphs whose weight inputs are the int8 payloads + f32 scales."""
        def qfn(qparams, *leaves):
            return fn(self.dequantize(qparams, dtype), *leaves)
        return qfn
