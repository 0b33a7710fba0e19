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


def test_dw_splits_cover_the_positions():
    for rows, co, positions in ((576, 64, 802816), (4608, 512, 12544),
                                (72, 16, 128), (9, 3, 7)):
        splits, chunk = tfc._dw_splits(rows, co, positions)
        assert chunk % 16 == 0 and splits >= 1
        assert (splits - 1) * chunk < positions <= splits * chunk


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
    for k, stride, h, ci, co, res_on, relu in CASES:
        arrays = _inputs(k, h, ci, co, res_on, seed=3)
        x, sc, sh, w, res = [None if a is None else
                             torch.from_numpy(a).to(dev) for a in arrays]
        x, w = x.to(dt), w.to(dt)
        res = None if res is None else res.to(dt)
        out = tfc._fwd_cuda(x, sc, sh, w, res, relu, stride)
        do = torch.randn(out.shape, device=dev).to(dt)
        got = (out,) + tfc._dx_cuda(x, sc, sh, w, res, do, relu, stride) \
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
