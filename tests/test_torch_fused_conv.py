"""Port parity: ``mxnet_tpu_torch.ops.fused_conv`` against the JAX
package's fused norm -> relu -> conv.

The same numpy inputs (seeded) go through the JAX ``norm_relu_conv`` —
the Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU — and the port's ``norm_relu_conv``, whose
``autograd.Function`` runs the plain versions of its three kernels for
CPU tensors.  Forward and the gradients in x, scale, shift, w and the
residual are compared at the JAX tests' tolerances in float32
(``tests/test_fused_conv.py``): 2e-4 forward, 2e-3 gradients — the two
sides sum the same f32 terms in another order.

Each plain version is also held against torch autograd of the plain
composition ``norm_relu_conv_reference``.  The CUDA kernels run only on
the card: the ``gpu``-marked test skips here and runs with
``python -m pytest -m gpu tests/test_torch_fused_conv.py`` on a machine
with one.
"""
import gc
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.fused_conv import norm_relu_conv as jax_nrc
from mxnet_tpu_torch.ops import fused_conv as tfc

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
gpu = pytest.mark.gpu

# (k, stride, h, ci, co, residual, relu): the JAX tests' grid of (k,
# residual, relu), stride 2 at even and odd extents, Co = 192
CASES = [
    (3, 1, 8, 8, 16, False, True),
    (1, 1, 8, 8, 16, False, True),
    (3, 1, 8, 8, 16, True, True),
    (3, 1, 8, 8, 16, True, False),
    (3, 2, 8, 8, 16, False, True),
    (3, 2, 9, 8, 16, False, True),
    (1, 2, 8, 8, 16, False, True),
    (3, 1, 4, 8, 192, False, True),
]


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker, so that module's
    memory accounting does not see it freed mid-test."""
    yield
    gc.collect()


def _inputs(k, h, ci, co, res_on, seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    sc = (rng.rand(ci) + 0.5).astype(np.float32)
    sh = (0.1 * rng.randn(ci)).astype(np.float32)
    w = (0.2 * rng.randn(k, k, ci, co)).astype(np.float32)
    res = rng.randn(n, h, h, ci).astype(np.float32) if res_on else None
    return x, sc, sh, w, res


def _torch_grads(fn, arrays, stride, relu):
    ts = [None if a is None else torch.from_numpy(a).requires_grad_()
          for a in arrays]
    x, sc, sh, w, res = ts
    out = fn(x, sc, sh, w, residual=res, relu=relu, stride=stride)
    (out.float() ** 2).sum().backward()
    return out.detach().numpy(), [None if t is None else t.grad.numpy()
                                  for t in ts]


@pytest.mark.parametrize("k,stride,h,ci,co,res_on,relu", CASES)
def test_norm_relu_conv_matches_jax_interpret(k, stride, h, ci, co, res_on,
                                              relu):
    arrays = _inputs(k, h, ci, co, res_on)
    jargs = [jnp.asarray(a) for a in arrays if a is not None]

    def loss(x, sc, sh, w, res=None):
        o = jax_nrc(x, sc, sh, w, residual=res, relu=relu, stride=stride,
                    block_co=8, interpret=True)
        return (o.astype(jnp.float32) ** 2).sum()

    jout = np.asarray(jax_nrc(*jargs[:4], residual=(jargs[4] if res_on
                                                    else None),
                              relu=relu, stride=stride, block_co=8,
                              interpret=True))
    jgrads = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    tout, tgrads = _torch_grads(tfc.norm_relu_conv, arrays, stride, relu)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, **FWD_TOL)
    for i, (a, b) in enumerate(zip([g for g in tgrads if g is not None],
                                   jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL,
                                   err_msg=f"grad argnum {i}")


@pytest.mark.parametrize("k,stride,h,ci,co,res_on,relu", CASES)
def test_plain_versions_match_autograd_of_reference(k, stride, h, ci, co,
                                                   res_on, relu):
    """Each kernel's plain version against torch autograd of the plain
    composition: forward, dx/dres/dscale/dshift, dW."""
    arrays = _inputs(k, h, ci, co, res_on, seed=1)
    x, sc, sh, w, res = [None if a is None else torch.from_numpy(a)
                         for a in arrays]
    rng = np.random.RandomState(2)
    out = tfc._fwd_plain(x, sc, sh, w, res, relu, stride)
    do = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    ref_out, _ = _torch_grads(tfc.norm_relu_conv_reference, arrays, stride,
                              relu)
    np.testing.assert_allclose(out.numpy(), ref_out, **FWD_TOL)

    ts = [None if t is None else t.clone().requires_grad_()
          for t in (x, sc, sh, w, res)]
    ref = tfc.norm_relu_conv_reference(ts[0], ts[1], ts[2], ts[3],
                                       residual=ts[4], relu=relu,
                                       stride=stride)
    ref.backward(do)
    dx, dres, dsc, dsh = tfc._dx_plain(x, sc, sh, w, res, do, relu, stride)
    dw = tfc._dw_plain(x, sc, sh, res, do, k, relu, stride)
    assert dsc.dtype == dsh.dtype == dw.dtype == torch.float32
    assert dsc.shape == dsh.shape == (ci,)
    for got, want in ((dx, ts[0].grad), (dsc, ts[1].grad),
                      (dsh, ts[2].grad), (dw, ts[3].grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL)
    if res_on:
        np.testing.assert_allclose(dres.numpy(), ts[4].grad.numpy(),
                                   **GRAD_TOL)
    else:
        assert dres is None


def test_plain_versions_sum_in_f64_on_request():
    """``acc=torch.float64`` (the card run's reference at batch 256):
    the same function, with the conv and channel sums in f64."""
    arrays = _inputs(3, 9, 8, 16, True, seed=4)
    x, sc, sh, w, res = [torch.from_numpy(a) for a in arrays]
    do = torch.from_numpy(np.random.RandomState(5)
                          .randn(2, 5, 5, 16).astype(np.float32))
    f64 = torch.float64
    pairs = [(tfc._fwd_plain(x, sc, sh, w, res, True, 2),
              tfc._fwd_plain(x, sc, sh, w, res, True, 2, f64))]
    pairs += zip(tfc._dx_plain(x, sc, sh, w, res, do, True, 2),
                 tfc._dx_plain(x, sc, sh, w, res, do, True, 2, f64))
    pairs.append((tfc._dw_plain(x, sc, sh, res, do, 3, True, 2),
                  tfc._dw_plain(x, sc, sh, res, do, 3, True, 2, f64)))
    assert [b.dtype for _, b in pairs] == [torch.float32] * 3 + [f64] * 3
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_rejects_unsupported_shapes():
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match="1x1/3x3"):
        tfc.norm_relu_conv(x, torch.ones(4), torch.zeros(4),
                           torch.zeros(5, 5, 4, 4))
    with pytest.raises(ValueError, match="1x1/3x3"):
        tfc.norm_relu_conv(x, torch.ones(4), torch.zeros(4),
                           torch.zeros(3, 3, 4, 4), stride=3)
    with pytest.raises(ValueError, match="Ci"):
        tfc.norm_relu_conv(x, torch.ones(4), torch.zeros(4),
                           torch.zeros(3, 3, 8, 4))
    assert tfc.supports(3, 3, 2) and not tfc.supports(3, 3, 1, groups=2)


def test_cpu_runs_no_kernel_and_a_mix_of_devices_raises():
    arrays = _inputs(3, 8, 8, 16, False)
    before = dict(tfc.norm_relu_conv.launches)
    _torch_grads(tfc.norm_relu_conv, arrays, 1, True)
    assert tfc.norm_relu_conv.launches == before
    meta = torch.empty(2, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU"):
        tfc._use_plain((meta, torch.ones(8), torch.zeros(8),
                        torch.zeros(3, 3, 8, 16), None))
    assert tfc._use_plain((torch.zeros(1), None))


# the eight fused convs of ResNet-50 v1: (hw, ci, co, k), as chip_smoke.py
# lists them; and the small shapes above
RESNET50_SHAPES = [(56, 64, 64, 3), (56, 64, 256, 1), (28, 128, 128, 3),
                   (28, 128, 512, 1), (14, 256, 256, 3), (14, 256, 1024, 1),
                   (7, 512, 512, 3), (7, 512, 2048, 1)]


def test_dw_splits_cover_the_positions():
    """The dW kernel's split plan covers every position exactly once, in
    chunks of whole 64-position steps, every split non-empty."""
    shapes = [(256 * hw * hw, k * k * ci, co)
              for hw, ci, co, k in RESNET50_SHAPES]
    shapes += [(2 * (-(-h // s)) ** 2, k * k * ci, co)
               for k, s, h, ci, co, _, _ in CASES]
    shapes += [(128, 72, 16), (7, 9, 8)]
    for (positions, rows, co), halo in itertools.product(shapes,
                                                         (False, True)):
        splits, chunk = tfc._dw_splits(rows, co, positions, halo)
        assert chunk % tfc._DEPTH == 0 and splits >= 1
        assert (splits - 1) * chunk < positions <= splits * chunk
        covered = np.zeros(positions, np.int64)
        for i in range(splits):
            covered[i * chunk:min(positions, (i + 1) * chunk)] += 1
        assert (covered == 1).all(), (positions, rows, co, halo)


def test_b_operand_split_holds_f32():
    """An f32 B (w or dO) goes to the kernels as its bf16 pieces (hi,
    mid, lo): hi + mid holds it to 2**-16 relative, all three to 2**-23;
    a bf16 B goes as it is."""
    rng = np.random.RandomState(6)
    t = torch.from_numpy((rng.randn(3, 3, 8, 40)
                          * 10.0 ** rng.uniform(-6, 6, (3, 3, 8, 40)))
                         .astype(np.float32))
    pieces = tfc._b_operand(t)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3,) + t.shape
    t64, p64 = t.double(), pieces.double()
    for n, bound in ((2, 2.0 ** -16), (3, 2.0 ** -23)):
        back = p64[:n].sum(dim=0)
        assert bool(((back - t64).abs() <= bound * t64.abs()).all()), n
    b = t.to(torch.bfloat16)
    assert tfc._b_operand(b) is b
    with pytest.raises(ValueError, match="multiples of 8"):
        tfc._check_widths("fused_conv_fwd", 12, 16)
    tfc._check_widths("fused_conv_fwd", 8, 40)


def _pieces(t, n):
    """t as n bf16 pieces, each the rounded remainder of the ones before
    (the kernels' split of X; the wrapper's of an f32 B)."""
    out, rest = [], t.float()
    for _ in range(n):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return [p.double() for p in out]


def _split_terms(X, B, f32):
    """The kernels' product terms as pairs of f64 operands: bf16 inputs
    take X in two pieces times B (exact in bf16); f32 inputs cut X and B
    in three pieces each and take the six products whose piece orders
    sum to at most 2."""
    if not f32:
        return [(x, B.double()) for x in _pieces(X, 2)]
    xs, bs = _pieces(X, 3), _pieces(B, 3)
    return [(xs[i], bs[j]) for i in range(3) for j in range(3) if i + j <= 2]


def _hold(got, want, dtype):
    """chip_smoke.py's check_outputs rule: each element within rtol of
    the output's largest magnitude plus its own; rtol 1e-4 for f32
    outputs, 2**-6 for bf16 ones."""
    rtol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    got, want = got.double(), want.double()
    err = (got - want).abs()
    assert bool((err <= rtol * (want.abs().max() + want.abs())).all()), \
        float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,ci,co,k", RESNET50_SHAPES[:2])
def test_split_products_hold_the_f64_plain_versions(hw, ci, co, k, dtype):
    """The tensor-core kernels' arithmetic, emulated: X from the plain
    prologue cut into bf16 pieces, times B (bf16: two terms; f32: B cut
    too, six terms), each product exact and summed in f64,
    against ``_fwd_plain``/``_dw_plain`` summed in f64, under the card
    check's rule, at the two stage-1 shapes at N = 4."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(7)
    n = 4
    x = torch.from_numpy(rng.randn(n, hw, hw, ci).astype(np.float32)).to(dt)
    sc = torch.from_numpy((rng.rand(ci) + 0.5).astype(np.float32))
    sh = torch.from_numpy((0.1 * rng.randn(ci)).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, k, ci, co)
                          * (2.0 / (k * k * ci)) ** 0.5)
                         .astype(np.float32)).to(dt)
    do = torch.from_numpy(rng.randn(n, hw, hw, co).astype(np.float32)).to(dt)
    f64, f32 = torch.float64, dtype == "float32"
    X = tfc._prologue(x, sc, sh, None, True)

    out = sum(torch.nn.functional.conv2d(
        tfc._padded_nchw(a, k, 1), b.permute(3, 2, 0, 1))
        for a, b in _split_terms(X, w, f32))
    out = out.permute(0, 2, 3, 1).to(dt)
    want = tfc._fwd_plain(x, sc, sh, w, None, True, 1, f64)
    assert out.shape == want.shape and want.dtype == dt
    _hold(out, want, dt)

    dw = sum(torch.nn.grad.conv2d_weight(
        tfc._padded_nchw(a, k, 1), (co, ci, k, k), b.permute(0, 3, 1, 2))
        for a, b in _split_terms(X, do, f32))
    dw = dw.permute(2, 3, 1, 0).float()
    want = tfc._dw_plain(x, sc, sh, None, do, k, True, 1, f64).float()
    assert dw.shape == want.shape == (k, k, ci, co)
    _hold(dw, want, torch.float32)


def _halo_dx(x, sc, sh, w, res, do, relu):
    """``(dx, dres, dscale, dshift)`` by the tensor-core dX's own walk
    (stride 1), on flattened NHWC rows: per block of 128 input positions,
    the halo of dO rows from ``m0 - lead`` (zero rows outside the
    tensor), each tap's A rows read at the mirrored offset ``(pad - ky) W
    + (pad - kx)`` from the position's own, a zero row where the tap
    leaves the image; G summed in f32 over taps (bf16 products, exact);
    the epilogue's mask from ``x*scale + shift [+ res]``; per 64-row tile
    the column sums in the kernel's order (a thread's two rows, the
    shuffle tree over the warp's eight row groups, the four warps in
    turn), then the tiles in ``reduce_rows``' order (32 lanes of rows,
    then the lanes)."""
    n, h, wd, ci = x.shape
    k, co = w.shape[0], w.shape[3]
    pad = (k - 1) // 2
    P = n * h * wd
    lead = (k - 1 - pad) * wd + (k - 1 - pad)
    rows = 128 + (k - 1) * (wd + 1)
    dof, wf = do.float().reshape(P, co), w.float()
    G = torch.zeros(P, ci)
    for m0 in range(0, P, 128):
        src = torch.arange(rows) + m0 - lead
        halo = torch.where(((src >= 0) & (src < P))[:, None],
                           dof[src.clamp(0, P - 1)], torch.zeros(()))
        m = m0 + torch.arange(128)
        y, xx = (m % (h * wd)) // wd, m % wd
        for ky in range(k):
            for kx in range(k):
                oy, ox = y + pad - ky, xx + pad - kx
                ok = (m < P) & (oy >= 0) & (oy < h) & (ox >= 0) & (ox < wd)
                hr = torch.arange(128) + lead + (pad - ky) * wd + (pad - kx)
                a = torch.where(ok[:, None], halo[hr], torch.zeros(()))
                blk = a @ wf[ky, kx].T
                G[m0:m0 + 128][: P - m0] += blk[: P - m0]
    pre = x.float().reshape(P, ci) * sc + sh
    if res is not None:
        pre = pre + res.float().reshape(P, ci)
    gm = torch.where(pre > 0.0, G, torch.zeros(())) if relu else G
    dx = (gm * sc).to(x.dtype).reshape(x.shape)
    dres = None if res is None else gm.to(res.dtype).reshape(x.shape)

    def total(v):
        t = -(-P // 64)
        v = torch.cat([v, torch.zeros(t * 64 - P, ci)]).view(t, 4, 2, 8, ci)
        s = v[:, :, 0] + v[:, :, 1]                    # a thread's rows
        s = s[:, :, 0::2] + s[:, :, 1::2]              # lanes xor 4
        s = s[:, :, 0::2] + s[:, :, 1::2]              # xor 8
        s = s[:, :, 0] + s[:, :, 1]                    # xor 16
        part = ((s[:, 0] + s[:, 1]) + s[:, 2]) + s[:, 3]
        lanes = torch.zeros(32, ci)
        for r in range(t):                             # reduce_rows
            lanes[r % 32] += part[r]
        out = torch.zeros(ci)
        for i in range(32):
            out += lanes[i]
        return out
    return dx, dres, total(gm * x.float().reshape(P, ci)), total(gm)


@pytest.mark.parametrize("h,k,res_on", [(5, 3, False), (7, 3, True),
                                        (5, 1, True), (7, 1, False)])
def test_halo_dx_holds_the_f64_plain_version_and_jax(h, k, res_on):
    """The bf16 tensor-core dX's walk, emulated at odd H = W and N = 6
    (128-row blocks straddle images; taps at x = 0 and W - 1 must not
    wrap to the neighbouring row), Ci = 16 != Co = 24: against
    ``_dx_plain`` summed in f64 and the JAX ``_dx`` (interpret mode) on
    the same bf16 inputs, under the card check's rule (bf16 outputs
    2**-6, dscale/dshift 1e-4 of their scale)."""
    from mxnet_tpu.ops.pallas.fused_conv import _dx as jax_dx

    ci, co, n = 16, 24, 6
    x, sc, sh, w, res = _inputs(k, h, ci, co, res_on, seed=8, n=n)
    do = np.random.RandomState(9).randn(n, h, h, co).astype(np.float32)
    bf = torch.bfloat16
    tx, tw, tdo = (torch.from_numpy(a).to(bf) for a in (x, w, do))
    tres = None if res is None else torch.from_numpy(res).to(bf)
    tsc, tsh = torch.from_numpy(sc), torch.from_numpy(sh)
    got = _halo_dx(tx, tsc, tsh, tw, tres, tdo, True)
    want = [t if t is None or t.dtype != torch.float64 else t.float()
            for t in tfc._dx_plain(tx, tsc, tsh, tw, tres, tdo, True, 1,
                                   torch.float64)]
    jb = [None if t is None else jnp.asarray(t.float().numpy())
          .astype(jnp.bfloat16) for t in (tx, tw, tres, tdo)]
    jout = jax_dx(jb[0], jnp.asarray(sc), jnp.asarray(sh), jb[1], jb[2],
                  jb[3], True, 1, True)
    for i, (a, b, j) in enumerate(zip(got, want, jout)):
        if b is None:
            assert a is None and j is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        _hold(a, b, b.dtype)
        _hold(a, torch.from_numpy(np.asarray(j.astype(jnp.float32)))
              .to(a.dtype), a.dtype)


# ------------------------------------------------------------ on the card --
@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from mxnet_tpu_torch.context import resolve_device

    dev = resolve_device("cuda")
    dt = getattr(torch, dtype)
    # f32: the same f32 sums in another order; bf16: outputs round to
    # bf16 after that, so they may differ by one bf16 ulp (2**-8 relative)
    rtol = 1e-4 if dtype == "float32" else 2 ** -6
    # beyond CASES: a 1x1 and a 3x3 with a residual at odd H, Ci < 64 and
    # Ci != Co, and a 3x3 at Ci = 128 (in bf16 the tensor-core dX takes
    # them, with its last step on the B slot its epilogue reuses)
    for k, stride, h, ci, co, res_on, relu in CASES + [
            (1, 1, 7, 24, 40, True, True), (3, 1, 7, 16, 40, True, True),
            (3, 1, 5, 128, 64, False, True)]:
        arrays = _inputs(k, h, ci, co, res_on, seed=3)
        x, sc, sh, w, res = [None if a is None else
                             torch.from_numpy(a).to(dev) for a in arrays]
        x, w = x.to(dt), w.to(dt)
        res = None if res is None else res.to(dt)
        out = tfc._fwd_cuda(x, sc, sh, w, res, relu, stride)
        do = torch.randn(out.shape, device=dev).to(dt)
        dx = tfc._dx_cuda(x, sc, sh, w, res, do, relu, stride)
        again = tfc._dx_cuda(x, sc, sh, w, res, do, relu, stride)
        assert all(a is None or torch.equal(a, b)
                   for a, b in zip(dx, again)), (k, h, ci, co, dtype)
        got = (out,) + dx \
            + (tfc._dw_cuda(x, sc, sh, res, do, k, relu, stride),)
        want = (tfc._fwd_plain(x, sc, sh, w, res, relu, stride),) \
            + tfc._dx_plain(x, sc, sh, w, res, do, relu, stride) \
            + (tfc._dw_plain(x, sc, sh, res, do, k, relu, stride),)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            a, b = a.float(), b.float()
            tol = rtol * b.abs().max().item() + rtol * b.abs()
            assert bool(((a - b).abs() <= tol).all()), \
                (k, stride, h, co, res_on, relu, dtype)
