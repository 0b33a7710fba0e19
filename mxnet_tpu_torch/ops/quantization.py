"""INT8 quantization ops (the port of ``mxnet_tpu/ops/quantization.py``;
ref: src/operator/quantization/*.{h,cc,cu} — quantize_v2.cc,
dequantize.cc, quantized_fully_connected.cc, quantized_conv.cc).

Every int8 product accumulates in int32 and is exact, as the JAX
package's ``lax`` dot and conv with ``preferred_element_type=int32``
are.  ``int8_matmul`` is the one product all of them use:

- on the card, cuBLASLt's int8 GEMM (``torch._int_mm``), which wants
  more than 16 rows and K and N multiples of 8, so the operands are
  padded with zeros (a zero adds nothing to an integer sum): the stem
  conv's K = 147, a batch-1 FC's single row;
- on the host, its plain version: the same product in int64, cast to
  int32.

A card tensor takes the ``_int_mm`` route or raises; it never becomes a
float product (f32 accumulation is not exact: 9 x 2048 products of up to
127^2 pass 2^24).  ``quantized_conv`` is im2col (one strided view of the
padded int8 input: any layout, stride, dilation and group count)
followed by that product.  ``int8_matmul.launches`` counts the card's
GEMMs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

from .nn import _bias_shape, _channels_last, _to_first, _tup
from .registry import register_op

__all__ = ["int8_matmul", "int8_matmul_reference", "im2col"]


def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul_reference(a, b):
    """``a (M, K) @ b (N, K)^T`` of int8 operands as int32, in int64 on
    the operands' device (the plain version)."""
    return (a.to(torch.int64) @ b.to(torch.int64).t()).to(torch.int32)


def int8_matmul(a, b):
    """``a (M, K) @ b (N, K)^T`` of int8 operands with exact int32
    accumulation: cuBLASLt's int8 GEMM on the card, the plain version on
    the host."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if not a.is_cuda:
        return int8_matmul_reference(a, b)
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = tnf.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = tnf.pad(b, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    int8_matmul.launches += 1
    return out[:m, :n]


int8_matmul.launches = 0


def _scale(lo, hi):
    """``max(|lo|, |hi|) / 127``: a Python float when both are numbers,
    else a 0-d f32 tensor on their device (no host copy, so a captured
    graph can hold it)."""
    ts = [v for v in (lo, hi) if isinstance(v, torch.Tensor)]
    fs = [abs(float(v)) for v in (lo, hi) if not isinstance(v, torch.Tensor)]
    if not ts:
        return max(fs) / 127.0
    m = ts[0].float().abs()
    m = torch.maximum(m, ts[1].float().abs()) if len(ts) == 2 \
        else torch.clamp_min(m, fs[0])
    return m / 127.0


def _range_for(x, min_calib, max_calib):
    if min_calib is not None and max_calib is not None:
        return (torch.full((), float(min_calib), device=x.device),
                torch.full((), float(max_calib), device=x.device))
    return x.min().float(), x.max().float()


@register_op("quantize_v2")
def _quantize_v2(data, out_type="int8", min_calib_range=None,
                 max_calib_range=None):
    """Symmetric int8 quantization: ``(q, -amax, amax)``."""
    mn, mx = _range_for(data, min_calib_range, max_calib_range)
    amax = torch.maximum(mn.abs(), mx.abs())
    scale = 127.0 / torch.clamp_min(amax, 1e-10)
    q = torch.clamp(torch.round(data.float() * scale), -127, 127)
    return q.to(torch.int8), -amax, amax


@register_op("dequantize")
def _dequantize(data, min_range, max_range, out_type="float32"):
    return data.float() * _scale(min_range, max_range)


@register_op("quantized_fully_connected")
def _quantized_fc(data, weight, bias, min_data, max_data, min_weight,
                  max_weight, min_bias=None, max_bias=None, num_hidden=None,
                  no_bias=False, flatten=True):
    """int8 ``data @ weight^T`` (weight ``(num_hidden, K)``), dequantized
    to f32 with the data's and the weight's ranges; an f32 bias is added
    as is, an int8 one (with its range) dequantized first."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    acc = int8_matmul(x.reshape(-1, x.shape[-1]), weight)
    acc = acc.reshape(*lead, weight.shape[0])
    out = acc.float() * (_scale(min_data, max_data)
                         * _scale(min_weight, max_weight))
    if bias is not None and not no_bias:
        if min_bias is None or max_bias is None:
            out = out + bias.float()
        else:
            out = out + bias.float() * _scale(min_bias, max_bias)
    return out


@register_op("quantized_matmul")
def _quantized_matmul(a, b, scale_a, scale_b):
    """int8 ``a (..., M, K) @ b (K, N)`` times ``scale_a * scale_b``."""
    lead = a.shape[:-1]
    acc = int8_matmul(a.reshape(-1, a.shape[-1]), b.t())
    acc = acc.reshape(*lead, b.shape[-1])
    return acc.float() * (scale_a * scale_b)


def im2col(x, kernel, stride, pad, dilate):
    """Channel-first ``x (N, C, *S)`` as patch rows ``(N * prod(S_out),
    C * prod(kernel))`` (C major, then the kernel's offsets, as a
    ``(O, C, *kernel)`` weight flattens), and the output's spatial
    shape.  One strided view of the zero-padded input, then one copy."""
    nd = x.dim() - 2
    if any(pad):
        x = tnf.pad(x, [p for p in reversed(pad) for _ in (0, 1)])
    n, c, *size = x.shape
    out = [(size[i] - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
           for i in range(nd)]
    st = x.stride()
    view = x.as_strided(
        (n, *out, c, *kernel),
        (st[0], *[st[2 + i] * stride[i] for i in range(nd)], st[1],
         *[st[2 + i] * dilate[i] for i in range(nd)]))
    rows = 1
    for o in out:
        rows *= o
    return view.reshape(n * rows, -1), out


@register_op("quantized_conv")
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, kernel=None, stride=None, pad=None,
                    num_filter=None, num_group=1, no_bias=True, layout=None,
                    dilate=None):
    """int8 convolution with exact int32 accumulation (ref:
    src/operator/quantization/quantized_conv.cc): the layout contract of
    ``Convolution``; the output dequantized to f32 (the reference emits
    int32 with ranges), plus the f32 bias."""
    nd = data.dim() - 2
    last = _channels_last(layout, nd)
    kernel = _tup(kernel, nd) if kernel else tuple(
        weight.shape[1:-1] if last else weight.shape[2:])
    stride = _tup(stride, nd) if stride else (1,) * nd
    pad = _tup(pad, nd) if pad else (0,) * nd
    dilate = _tup(dilate, nd) if dilate else (1,) * nd
    x = _to_first(data) if last else data
    w = _to_first(weight) if last else weight
    x, w = x.to(torch.int8), w.to(torch.int8)
    g = int(num_group)
    o = w.shape[0]
    cg = x.shape[1] // g
    accs = []
    for j in range(g):
        xj = x[:, j * cg:(j + 1) * cg] if g > 1 else x
        cols, size = im2col(xj, kernel, stride, pad, dilate)
        wj = w[j * (o // g):(j + 1) * (o // g)].reshape(o // g, -1)
        accs.append(int8_matmul(cols, wj))
    acc = accs[0] if g == 1 else torch.cat(accs, dim=1)
    acc = acc.reshape(x.shape[0], *size, o)             # channel-last
    out = acc.float() * (_scale(min_data, max_data)
                         * _scale(min_weight, max_weight))
    if not last:
        out = _to_first(out)
    if bias is not None and not no_bias:
        out = out + bias.float().reshape(_bias_shape(nd, last))
    return out
