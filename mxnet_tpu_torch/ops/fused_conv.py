"""Fused norm -> relu -> conv: ``conv(relu(x*scale + shift [+ res]), w)``.

The port of ``mxnet_tpu/ops/pallas/fused_conv.py``.  In a ResNet block
the normalised activation ``relu(bn(y))`` exists only to be read by the
next convolution; these ops form it from the raw ``y`` as the conv reads
it, so it is never written to device memory, in the forward or in
either backward kernel (both recompute it from ``x``).

Scope, as in the JAX module: NHWC activations, HWIO weights, kernel
1x1 or 3x3, stride 1 or 2, SAME padding, one group.  ``scale``/``shift``
are the per-channel affine terms already folded from BN statistics
(``gamma / sqrt(var + eps)``, ``beta - mean * scale``); they stay in the
autograd graph, so the batch-statistics gradients of BN reach ``x``
through ``d scale`` and ``d shift``.

Three kernels, each with its plain PyTorch version beside it:

- forward ``_fwd`` (``_fwd_plain``): ``out`` in ``x.dtype``;
- ``_dx`` (``_dx_plain``): ``G = dO (*) flip(w)``, the relu mask from
  the raw ``x``, ``dx = G*m*scale``, ``dres = G*m`` and the channel sums
  ``dscale = sum G*m*x``, ``dshift = sum G*m`` (f32);
- ``_dw`` (``_dw_plain``): ``dW = sum over positions of X_tap^T dO``
  (f32; the autograd wrapper casts it to ``w.dtype``).

A plain version sums in f32 as its kernel does; given
``acc=torch.float64`` it sums in f64 (the prologue and the relu mask
stay f32), a reference for the kernels' f32 sums over many positions.

Which body runs is decided by where the tensors lie, never by a
fallback: CPU tensors run the plain versions; CUDA tensors launch the
hand-written kernels of ``ops/cuda/fused_conv.cu`` (float32 or bfloat16
``x``/``w``/``res``/``dO``, f32 ``scale``/``shift``; Ci and Co multiples
of 8, tensors 16-byte aligned) or raise.  The forward and dW kernels
multiply on the tensor cores in bf16 pieces with f32-accurate products
(an f32 ``w``/``dO`` goes to them as its three bf16 pieces,
``_b_operand``); so does dX in bf16 at stride 1 (its operands dO and w
are exact bf16), while f32 and stride-2 dX keep a SIMT f32 kernel.
``norm_relu_conv.launches`` counts kernel launches per kernel
(``"fwd"``, ``"dx"``, ``"dw"``).

The dscale/dshift sums across blocks and the dW sum across position
chunks are per-block f32 partials added by a second pass in a fixed
order (no atomics), so the kernels give the same bits on every run;
against the plain versions they differ only by f32 summation order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["supports", "norm_relu_conv", "norm_relu_conv_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64                  # rows/cols of a kernel's result tile
_DEPTH = 64                 # dW: positions in one staged step
_TARGET_BLOCKS = 4 * 132    # dW: enough blocks for four waves on 132 SMs
_MIN_STEPS = 8              # dW: least depth steps a split takes


def supports(kh, kw, stride, groups=1):
    """True when the fused kernels cover this conv configuration."""
    return (kh, kw) in ((1, 1), (3, 3)) and stride in (1, 2) and groups == 1


def _out_dim(n, stride):
    """SAME-padding output extent."""
    return -(-n // stride)


def _same_pads(n, k, stride):
    """(pad_lo, pad_hi) of SAME padding along one spatial dim."""
    total = max((_out_dim(n, stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _prologue(x, scale, shift, res, relu):
    """X = relu(x*scale + shift [+ res]) in f32 (shared by all three)."""
    pre = x.float() * scale + shift
    if res is not None:
        pre = pre + res.float()
    return torch.relu(pre) if relu else pre


# ------------------------------------------------------- plain versions ----
def _padded_nchw(X, k, stride):
    """NHWC -> its SAME zero padding as an NCHW view."""
    _, h, wd, _ = X.shape
    py, py2 = _same_pads(h, k, stride)
    px, px2 = _same_pads(wd, k, stride)
    return F.pad(X, (0, 0, px, px2, py, py2)).permute(0, 3, 1, 2)


def _fwd_plain(x, scale, shift, w, res, relu, stride, acc=torch.float32):
    """The forward kernel's function: f32 prologue, conv summed in
    ``acc`` (f32 as the kernel sums; f64 gives a reference), out in
    ``x.dtype``."""
    X = _prologue(x, scale, shift, res, relu).to(acc)
    Xp = _padded_nchw(X, w.shape[0], stride)
    out = F.conv2d(Xp, w.to(acc).permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _dx_plain(x, scale, shift, w, res, do, relu, stride, acc=torch.float32):
    """The dX kernel's function: ``(dx, dres, dscale, dshift)`` with
    ``dres`` None without a residual; the relu mask from the f32
    pre-activation, the conv and the channel sums in ``acc``."""
    n, h, wd, ci = x.shape
    k = w.shape[0]
    py, py2 = _same_pads(h, k, stride)
    px, px2 = _same_pads(wd, k, stride)
    size = (n, ci, h + py + py2, wd + px + px2)
    Gp = torch.nn.grad.conv2d_input(size, w.to(acc).permute(3, 2, 0, 1),
                                    do.to(acc).permute(0, 3, 1, 2),
                                    stride=stride)
    G = Gp[:, :, py:py + h, px:px + wd].permute(0, 2, 3, 1)
    if relu:
        pre = x.float() * scale + shift
        if res is not None:
            pre = pre + res.float()
        G = torch.where(pre > 0.0, G, torch.zeros_like(G))
    dx = (G * scale).to(x.dtype).contiguous()
    dres = None if res is None else G.to(res.dtype).contiguous()
    return dx, dres, (G * x.to(acc)).sum(dim=(0, 1, 2)), G.sum(dim=(0, 1, 2))


def _dw_plain(x, scale, shift, res, do, k, relu, stride, acc=torch.float32):
    """The dW kernel's function: ``(k, k, Ci, Co)``, summed in ``acc``."""
    X = _prologue(x, scale, shift, res, relu).to(acc)
    Xp = _padded_nchw(X, k, stride)
    co = do.shape[3]
    dw = torch.nn.grad.conv2d_weight(Xp, (co, X.shape[3], k, k),
                                     do.to(acc).permute(0, 3, 1, 2),
                                     stride=stride)
    return dw.permute(2, 3, 1, 0).contiguous()


# -------------------------------------------------------- CUDA wrappers ----
def _geometry(x, k, co, stride):
    """The kernels' integer arguments: n, h, w, ci, co, k, stride, ho,
    wo and the low-side SAME pads."""
    n, h, wd, ci = x.shape
    return (n, h, wd, ci, co, k, stride, _out_dim(h, stride),
            _out_dim(wd, stride), _same_pads(h, k, stride)[0],
            _same_pads(wd, k, stride)[0])


def _check_cuda(what, x, scale, shift, others):
    """Types, devices and layout the kernels take; raises on the rest.
    ``others`` are the tensors that share ``x``'s type (w, res, dO)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for t in others:
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{what} kernel: w/residual/dO must have x's "
                            f"dtype {x.dtype}, got {t.dtype}")
    for t in (scale, shift):
        if t.dtype != torch.float32 or t.shape != (x.shape[3],):
            raise TypeError(f"{what} kernel: scale/shift must be float32 "
                            f"({x.shape[3]},), got {t.dtype} "
                            f"{tuple(t.shape)}")
    tensors = [x, scale, shift] + [t for t in others if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: inputs on several devices")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             f"16-byte aligned")


def _check_widths(what, ci, co):
    """The tensor-core kernels copy 16-byte rows: Ci and Co multiples of
    8 (every ResNet width is)."""
    if ci % 8 or co % 8:
        raise ValueError(f"{what} kernel takes Ci and Co in multiples of "
                         f"8, got Ci={ci} Co={co}")


def _b_operand(t):
    """The kernels' B operand (w or dO): a bf16 tensor as it is; an f32
    one as its bf16 pieces ``(hi, mid, lo)`` stacked on a new first axis,
    ``hi = bf16(t)`` and each further piece the rounded remainder, so that
    their sum holds t to ~2**-24 relative and the kernels' bf16 products
    stay f32-accurate."""
    if t.dtype == torch.bfloat16:
        return t
    pieces, rest = [], t
    for _ in range(3):
        pieces.append(rest.to(torch.bfloat16))
        rest = rest - pieces[-1].float()
    return torch.stack(pieces)


def _launch(fn, what, *args):
    from .cuda import check

    check(fn(*args), what)
    norm_relu_conv.launches[what.rsplit("_", 1)[1]] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_cuda(x, scale, shift, w, res, relu, stride):
    from .cuda import load

    _check_cuda("fused_conv_fwd", x, scale, shift, (w, res))
    _check_widths("fused_conv_fwd", x.shape[3], w.shape[3])
    g = _geometry(x, w.shape[0], w.shape[3], stride)
    out = torch.empty((g[0], g[7], g[8], g[4]), dtype=x.dtype,
                      device=x.device)
    wb = _b_operand(w)
    lib = load("fused_conv")
    with torch.cuda.device(x.device):
        _launch(lib.fused_conv_fwd, "fused_conv_fwd", _DTYPE_CODES[x.dtype],
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                wb.data_ptr(), _ptr(res), out.data_ptr(), *g, int(relu),
                _stream(x))
    return out


def _dx_cuda(x, scale, shift, w, res, do, relu, stride):
    from .cuda import load

    _check_cuda("fused_conv_dx", x, scale, shift, (w, res, do))
    g = _geometry(x, w.shape[0], w.shape[3], stride)
    n, h, wd, ci = x.shape
    rows = -(-(n * h * wd) // _TILE)
    dx = torch.empty_like(x)
    dres = None if res is None else torch.empty_like(res)
    part = torch.empty((2, rows, ci), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, ci), dtype=torch.float32, device=x.device)
    lib = load("fused_conv")
    with torch.cuda.device(x.device):
        _launch(lib.fused_conv_dx, "fused_conv_dx", _DTYPE_CODES[x.dtype],
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                w.data_ptr(), do.data_ptr(), _ptr(res), dx.data_ptr(),
                _ptr(dres), part[0].data_ptr(), part[1].data_ptr(),
                sums[0].data_ptr(), sums[1].data_ptr(), *g, int(relu),
                _stream(x))
    return dx, dres, sums[0], sums[1]


def _dw_halo(x, k, res, stride):
    """True where ``fused_conv_dw`` takes its 3x3 halo kernel (bf16,
    stride 1, no residual, a halo of 64 + 2(W+1) rows within 256): a
    block then covers all nine taps of 64 x 64 channels."""
    return (x.dtype == torch.bfloat16 and stride == 1 and k == 3
            and res is None and 64 + 2 * (x.shape[2] + 1) <= 256)


def _dw_splits(rows, co, positions, halo=False):
    """How the dW kernel cuts the ``positions`` reduction for ``rows`` =
    k*k*Ci: ``(splits, chunk)`` so that tiles x splits gives about
    ``_TARGET_BLOCKS`` blocks, each split at least ``_MIN_STEPS`` steps
    of ``_DEPTH`` positions, ``chunk`` a multiple of ``_DEPTH``.  A block
    takes 64 (tap, ci) rows x 256 output channels, or with the halo
    kernel (``_dw_halo``) all nine taps of 64 x 64 channels."""
    if halo:
        tiles = -(-rows // (9 * _TILE)) * -(-co // _TILE)
    else:
        tiles = -(-rows // _TILE) * -(-co // (4 * _TILE))
    steps = -(-positions // _DEPTH)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles),
                        -(-steps // _MIN_STEPS)))
    chunk = -(-steps // splits) * _DEPTH
    return -(-positions // chunk), chunk


def _dw_cuda(x, scale, shift, res, do, k, relu, stride):
    from .cuda import load

    _check_cuda("fused_conv_dw", x, scale, shift, (res, do))
    co = do.shape[3]
    _check_widths("fused_conv_dw", x.shape[3], co)
    g = _geometry(x, k, co, stride)
    rows = k * k * x.shape[3]
    splits, chunk = _dw_splits(rows, co, g[0] * g[7] * g[8],
                               _dw_halo(x, k, res, stride))
    dw = torch.empty((k, k, x.shape[3], co), dtype=torch.float32,
                     device=x.device)
    part = dw if splits == 1 else torch.empty(
        (splits, rows * co), dtype=torch.float32, device=x.device)
    dob = _b_operand(do)
    lib = load("fused_conv")
    with torch.cuda.device(x.device):
        _launch(lib.fused_conv_dw, "fused_conv_dw", _DTYPE_CODES[x.dtype],
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                dob.data_ptr(), _ptr(res), part.data_ptr(), dw.data_ptr(),
                *g, int(relu), splits, chunk, _stream(x))
    return dw


def _use_plain(tensors):
    """True for CPU tensors, False for CUDA tensors; raises on a mix."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds in ({"cpu"}, {"cuda"}):
        return kinds == {"cpu"}
    raise ValueError(f"fused_conv: inputs must all lie on the CPU or all "
                     f"on one CUDA device, got {sorted(kinds)}")


# (forward, dX, dW) bodies: the plain versions or the kernels
_BODIES = {True: (_fwd_plain, _dx_plain, _dw_plain),
           False: (_fwd_cuda, _dx_cuda, _dw_cuda)}


# ----------------------------------------------------------- public api ----
def norm_relu_conv_reference(x, scale, shift, w, residual=None, relu=True,
                             stride=1):
    """The plain PyTorch composition (test oracle): the normalised
    activation materialised in ``x.dtype``, then ``F.conv2d``."""
    X = _prologue(x, scale, shift, residual, relu).to(x.dtype)
    Xp = _padded_nchw(X, w.shape[0], stride)
    out = F.conv2d(Xp.float(), w.float().permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1).to(x.dtype)


class _NormReluConv(torch.autograd.Function):
    """Forward = the forward kernel; backward = the dX kernel plus the
    dW kernel (the JAX module's ``_core``/``_core_res`` custom VJPs)."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, residual, relu, stride):
        # the bodies chosen by the inputs' device serve the backward too
        ctx.bodies = _BODIES[_use_plain((x, scale, shift, w, residual))]
        ctx.relu, ctx.stride = relu, stride
        ctx.save_for_backward(x, scale, shift, w, residual)
        return ctx.bodies[0](x, scale.float(), shift.float(), w, residual,
                             relu, stride)

    @staticmethod
    def backward(ctx, do):
        x, scale, shift, w, residual = ctx.saved_tensors
        _, dx_body, dw_body = ctx.bodies
        s32, h32 = scale.float(), shift.float()
        do = do.to(x.dtype).contiguous()
        dx, dres, dsc, dsh = dx_body(x, s32, h32, w, residual, do, ctx.relu,
                                     ctx.stride)
        dw = dw_body(x, s32, h32, residual, do, w.shape[0], ctx.relu,
                     ctx.stride)
        return (dx, dsc.to(scale.dtype), dsh.to(shift.dtype),
                dw.to(w.dtype), dres, None, None)


def norm_relu_conv(x, scale, shift, w, residual=None, relu=True, stride=1):
    """``conv(relu(x*scale + shift [+ residual]), w)`` without
    materialising the normalised activation (forward or backward).

    x: ``(N, H, W, Ci)`` raw pre-norm activations; scale/shift: ``(Ci,)``
    affine folded from BN statistics (keep them in the autograd graph so
    the statistics' gradients flow); w: ``(k, k, Ci, Co)`` HWIO with k in
    {1, 3}; stride 1 or 2, SAME padding.  Differentiable in x, scale,
    shift, w and residual.  Returns ``(N, Ho, Wo, Co)`` in ``x.dtype``.
    """
    k = w.shape[0]
    if not supports(k, w.shape[1], stride):
        raise ValueError(f"fused kernel supports 1x1/3x3 stride 1/2; got "
                         f"{tuple(w.shape[:2])} stride {stride}")
    if w.dim() != 4 or x.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"norm_relu_conv: x {tuple(x.shape)} (NHWC) and "
                         f"w {tuple(w.shape)} (HWIO) disagree on Ci")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"norm_relu_conv: residual {tuple(residual.shape)}"
                         f" must have x's shape {tuple(x.shape)}")
    return _NormReluConv.apply(x, scale, shift, w, residual, bool(relu),
                               int(stride))


norm_relu_conv.launches = {"fwd": 0, "dx": 0, "dw": 0}

