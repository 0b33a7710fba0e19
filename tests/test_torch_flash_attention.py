"""Port parity: ``mxnet_tpu_torch.ops.flash_attention`` against the JAX
package's Pallas flash attention (interpret mode on the CPU).

- ``uniform01`` gives the JAX ``_uniform01``'s bits over a grid of
  (bh, q, k, seed), seeds near 2**31 - 1 and negative, positions past
  2**16 (the uint32 products wrap);
- the plain versions — forward O and lse, dQ, dK/dV — equal the JAX
  ``_flash_fwd`` / ``_flash_bwd`` in f32 within rtol 1e-5, atol 1e-6
  (the same products summed in another order), causal or not, dropout 0
  or 0.25 with the same explicit seed, B*H = 6 so a wrong (b, h) order
  of the hash would show;
- the autograd function (delta in f32, then dQ, then dK/dV) against
  ``jax.vjp`` of the JAX ``flash_attention``, in f32 and in bf16 (the
  tolerance of ``test_flash_bf16``);
- the op on ``(B, S, H*D)`` (B = 2, H = 3) against the JAX op, and with
  dropout against the JAX kernels fed the seed the op drew;
- ``torch.autograd.gradcheck`` of the function in f64 on the plain path;
- the bf16 tensor-core kernels' arithmetic emulated in plain PyTorch
  (the forward's online softmax over 64-key tiles; ``p`` and ``ds`` cut
  into hi + lo bf16 pieces, times the bf16 operands, summed in f32)
  against the JAX kernels and the plain versions summed in f64;
- the kernels' argument checks, a kernel library's name following its
  headers, and ``gpu``-marked kernel-against-plain and repeatability
  cases that skip without a card.
"""
import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ndarray import invoke
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import ops
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.ops.flash_attention import flash_attention, uniform01

jfa = importlib.import_module("mxnet_tpu.ops.pallas.flash_attention")
tfa = importlib.import_module("mxnet_tpu_torch.ops.flash_attention")

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=5e-2, atol=5e-2)
BH, S, D, SCALE, SEED = 6, 64, 16, 0.25, 1234567


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker."""
    yield
    gc.collect()


def arrays(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------- the hash --
def test_uniform01_bits_equal_jax():
    rng = np.random.RandomState(0)
    n = 4096
    top = 2 ** 31 - 1
    h = np.concatenate([rng.randint(0, 1 << 20, n - 4), [0, 5, 767, top]])
    q = np.concatenate([rng.randint(0, 1 << 24, n - 4),
                        [0, 65535, 65536, top]])
    k = np.concatenate([rng.randint(0, 1 << 24, n - 4),
                        [70000, 1 << 17, 0, 3]])
    seed = np.concatenate([rng.randint(-2 ** 31, 2 ** 31 - 1, n - 4),
                           [2 ** 31 - 1, 2 ** 31 - 2, -1, 0]])
    args = [a.astype(np.int32) for a in (h, q, k, seed)]
    want = np.asarray(jax.vmap(jfa._uniform01)(*map(jnp.asarray, args)))
    got = uniform01(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # a grid broadcast as the kernels draw it: (bh, q, k) for one seed
    g = [np.arange(n).astype(np.int32) for n in (6, 40, 40)]
    want = np.asarray(jfa._uniform01(
        jnp.asarray(g[0])[:, None, None], jnp.asarray(g[1])[None, :, None],
        jnp.asarray(g[2])[None, None, :], jnp.int32(2 ** 31 - 1)))
    got = uniform01(torch.arange(6)[:, None, None],
                    torch.arange(40)[None, :, None],
                    torch.arange(40)[None, None, :], 2 ** 31 - 1).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- plain versions --
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_plain_versions_equal_the_jax_kernels(causal, dropout):
    q, k, v, do = arrays(4, (BH, S, D), seed=1)
    seed = jnp.asarray([SEED], jnp.int32)
    jo, jl = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), seed, SCALE,
                            causal, 32, 32, True, dropout)
    to, tl = tfa._fwd_plain(*t(q, k, v), SCALE, causal, dropout, SEED)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jg = jfa._flash_bwd(*map(jnp.asarray, (q, k, v)), seed, jo, jl,
                        jnp.asarray(do), SCALE, causal, 32, 32, True,
                        dropout)
    tq, tk, tv, tdo = t(q, k, v, do)
    delta = (to * tdo).sum(-1)
    tdq = tfa._dq_plain(tq, tk, tv, tdo, tl, delta, SCALE, causal, dropout,
                        SEED)
    tdk, tdv = tfa._dkv_plain(tq, tk, tv, tdo, tl, delta, SCALE, causal,
                              dropout, SEED)
    for name, a, b in zip(("dq", "dk", "dv"), (tdq, tdk, tdv), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **F32)


def test_dropout_mask_follows_bh_order_and_seed():
    """Each of the B*H rows draws its own mask: permuting the rows of
    the inputs does not permute the outputs, and another seed gives
    another mask; lse does not depend on dropout."""
    q, k, v = arrays(3, (BH, S, D), seed=2)
    base, lse0 = tfa._fwd_plain(*t(q, k, v), SCALE, False, 0.0, 0)
    o1, lse1 = tfa._fwd_plain(*t(q, k, v), SCALE, False, 0.3, 7)
    o1b, _ = tfa._fwd_plain(*t(q, k, v), SCALE, False, 0.3, 7)
    o2, _ = tfa._fwd_plain(*t(q, k, v), SCALE, False, 0.3, 8)
    assert torch.equal(o1, o1b) and not torch.equal(o1, o2)
    assert torch.equal(lse1, lse0)
    perm = [1, 0, 2, 3, 4, 5]
    op, _ = tfa._fwd_plain(*t(q[perm], k[perm], v[perm]), SCALE, False,
                           0.3, 7)
    assert not torch.equal(op, o1[perm])
    assert abs(float(o1.mean()) - float(base.mean())) < 0.05


# ----------------------------------------------------------- the function --
def _jax_vjp(q, k, v, do, causal, dropout, dtype):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, scale=SCALE, causal=causal,
                                   block_q=32, block_k=32, dropout=dropout,
                                   seed=jnp.asarray([SEED], jnp.int32))
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(x.astype(jnp.float32))
            for x in (out,) + vjp(jnp.asarray(do).astype(dtype))]


def _port_grads(q, k, v, do, causal, dropout, dtype, **kw):
    tq, tk, tv = (x.to(dtype).requires_grad_(True) for x in t(q, k, v))
    out = flash_attention(tq, tk, tv, scale=SCALE, causal=causal,
                          dropout=dropout, seed=SEED, **kw)
    out.backward(torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy()
            for x in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("causal,dropout", [(False, 0.0), (True, 0.25)])
def test_function_matches_jax_vjp_f32(causal, dropout):
    q, k, v, do = arrays(4, (BH, S, D), seed=3)
    want = _jax_vjp(q, k, v, do, causal, dropout, jnp.float32)
    got = _port_grads(q, k, v, do, causal, dropout, torch.float32)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **F32)


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_function_matches_jax_vjp_bf16(dropout):
    q, k, v, do = arrays(4, (BH, S, D), seed=4)
    want = _jax_vjp(q, k, v, do, False, dropout, jnp.bfloat16)
    got = _port_grads(q, k, v, do, False, dropout, torch.bfloat16)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **BF16)


def test_blocks_do_not_change_the_result():
    q, k, v, do = arrays(4, (BH, S, D), seed=5)
    a = _port_grads(q, k, v, do, True, 0.25, torch.float32)
    b = _port_grads(q, k, v, do, True, 0.25, torch.float32, block_q=16,
                    block_k=64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("causal,dropout", [(False, 0.0), (True, 0.0),
                                            (False, 0.4), (True, 0.4)])
def test_gradcheck_f64(causal, dropout):
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, 5, 3)).requires_grad_(True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                        dropout=dropout, seed=99),
        (q, k, v))


# ----------------------------------------------------------------- the op --
def test_op_matches_jax_op():
    b, s, h, d = 2, 32, 3, 8
    q, k, v, w = arrays(4, (b, s, h * d), seed=7)
    jx = [mx.nd.array(x) for x in (q, k, v)]
    for x in jx:
        x.attach_grad()
    with jag.record():
        jo = invoke("flash_attention", *jx, heads=h, block_q=16, block_k=16)
        (jo * mx.nd.array(w)).sum().backward()
    tx = [x.requires_grad_(True) for x in t(q, k, v)]
    with tag.record():
        to = ops.flash_attention(*tx, heads=h)
        (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo.asnumpy(), **F32)
    for a, bb in zip(tx, jx):
        np.testing.assert_allclose(a.grad.numpy(), bb.grad.asnumpy(),
                                   rtol=1e-5, atol=1e-5)
    dense = ops.multi_head_attention(*t(q, k, v), heads=h)
    np.testing.assert_allclose(to.detach().numpy(), dense.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_op_dropout_masks_in_batch_major_head_minor_order():
    """With dropout in training mode the op draws one seed per call from
    the framework stream; the JAX kernels fed that seed on the JAX op's
    ``(B*H, S, D)`` layout give the same output."""
    b, s, h, d = 2, 32, 3, 8
    q, k, v = arrays(3, (b, s, h * d), seed=8)
    trandom.seed(21)
    seed = trandom.next_seed()
    trandom.seed(21)
    with tag.train_mode():
        out = ops.flash_attention(*t(q, k, v), heads=h, dropout=0.25)
    with tag.pause():
        assert torch.equal(ops.flash_attention(*t(q, k, v), heads=h,
                                               dropout=0.25),
                           ops.flash_attention(*t(q, k, v), heads=h))

    def bhsd(x):
        return jnp.transpose(jnp.asarray(x).reshape(b, s, h, d),
                             (0, 2, 1, 3)).reshape(b * h, s, d)
    jo = jfa.flash_attention(bhsd(q), bhsd(k), bhsd(v), dropout=0.25,
                             seed=jnp.asarray([seed], jnp.int32),
                             block_q=16, block_k=16)
    want = np.asarray(jo).reshape(b, h, s, d).transpose(0, 2, 1, 3) \
        .reshape(b, s, h * d)
    np.testing.assert_allclose(out.numpy(), want, **F32)


def test_dense_op_dropout_is_train_only():
    q, k, v = t(*arrays(3, (2, 16, 32), seed=9))
    base = ops.multi_head_attention(q, k, v, heads=4, dropout=0.5)
    with tag.train_mode():
        dropped = ops.multi_head_attention(q, k, v, heads=4, dropout=0.5)
    assert not torch.equal(base, dropped)
    with tag.pause():
        assert torch.equal(ops.multi_head_attention(q, k, v, heads=4,
                                                    dropout=0.5), base)


# ------------------------------------------- the tensor cores' arithmetic --
def _pieces(x):
    """f32 ``x`` as the kernels' bf16 pieces: hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_product(x, b):
    """``x @ b`` as the bf16 kernels form it: x (f32) in two bf16 pieces,
    b bf16, every product exact and all of them summed in one f32 sum."""
    hi, lo = _pieces(x)
    return torch.cat([hi, lo], dim=-1).float() \
        @ torch.cat([b, b], dim=-2).float()


def _split_bwd(q, k, v, do, lse, delta, scale, causal, dropout, seed):
    """dQ, dK, dV in f32 (before their rounding to bf16) by the bf16
    tensor-core kernels' arithmetic: S and dP from the bf16 inputs
    (exact products, f32 sums), ``scale`` on the S sum, ``p``, ``mask``
    and ``ds`` in f32, then ``ds K``, ``mask(p)^T dO`` and ``ds^T Q``
    through ``_split_product``."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = (qf @ kf.transpose(1, 2)) * scale
    if causal:
        n = s.shape[-1]
        s = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), s,
                        torch.tensor(tfa._NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = dof @ vf.transpose(1, 2)
    pd = p
    if dropout > 0.0:
        keep = tfa._keep(q.shape[0], q.shape[1], seed, dropout, q.device)
        pd, dp = tfa._drop(p, keep, dropout), tfa._drop(dp, keep, dropout)
    ds = p * (dp - delta[..., None])
    return (_split_product(ds, k) * scale,
            _split_product(ds.transpose(1, 2).contiguous(), q) * scale,
            _split_product(pd.transpose(1, 2).contiguous(), do))


def _hold_bf16(got, want, name):
    """chip_smoke.py's bf16 rule: each element within 2**-6 of the
    output's largest magnitude plus its own (two roundings of nearly
    the same value to bf16 differ by one bf16 ulp, 2**-8 to 2**-7
    relative)."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    assert bool((err <= 2.0 ** -6 * (want.abs().max() + want.abs())).all()), \
        (name, float(err.max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_split_products_hold_the_jax_kernels_and_f64_plain_versions(
        causal, dropout):
    """The bf16 dQ and dK/dV kernels' arithmetic, emulated: against the
    JAX kernels (interpret mode) on the same bf16 inputs, lse and delta,
    and against ``_dq_plain``/``_dkv_plain`` summed in f64, both under
    chip_smoke.py's bf16 rule; before the outputs' rounding to bf16,
    within 2**-12 of each output's largest magnitude of the f64 sums
    (the hi + lo split keeps p and ds to ~2**-16 relative; one bf16
    piece alone would keep them to 2**-9)."""
    q, k, v, do = (jnp.asarray(x).astype(jnp.bfloat16)
                   for x in arrays(4, (BH, S, D), seed=10))
    seed = jnp.asarray([SEED], jnp.int32)
    jo, jl = jfa._flash_fwd(q, k, v, seed, SCALE, causal, 32, 32, True,
                            dropout)
    jg = jfa._flash_bwd(q, k, v, seed, jo, jl, do, SCALE, causal, 32, 32,
                        True, dropout)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(torch.bfloat16) for x in (q, k, v, do))
    lse = torch.from_numpy(np.array(jl))
    delta = (torch.from_numpy(np.asarray(jo.astype(jnp.float32)))
             * tdo.float()).sum(-1)
    args = (SCALE, causal, dropout, SEED)
    split = _split_bwd(tq, tk, tv, tdo, lse, delta, *args)
    f64 = torch.float64
    exact = (tfa._dq_plain(*(x.double() for x in (tq, tk, tv, tdo)), lse,
                           delta, *args),
             *tfa._dkv_plain(*(x.double() for x in (tq, tk, tv, tdo)), lse,
                             delta, *args))
    plain = (tfa._dq_plain(tq, tk, tv, tdo, lse, delta, *args, acc=f64),
             *tfa._dkv_plain(tq, tk, tv, tdo, lse, delta, *args, acc=f64))
    for name, s32, jx, pl, ex in zip(("dq", "dk", "dv"), split, jg, plain,
                                     exact):
        got = s32.to(torch.bfloat16)
        _hold_bf16(got, torch.from_numpy(np.array(jx.astype(jnp.float32))),
                   name + " vs JAX")
        assert pl.dtype == torch.bfloat16
        _hold_bf16(got, pl, name + " vs f64 plain")
        err = float((s32.double() - ex).abs().max())
        assert err <= 2.0 ** -12 * float(ex.abs().max()), (name, err)


def _split_fwd(q, k, v, scale, causal, dropout, seed):
    """O (in f32, before its rounding to bf16) and lse by the bf16
    tensor-core forward's arithmetic: S from the bf16 inputs (exact
    products, f32 sums) times ``scale``, an online softmax over key tiles
    of 64 (running row max m and normaliser l, taken before dropout; O
    rescaled by alpha = exp(m_old - m_new)), the dropped p through
    ``_split_product`` against V, then O / l and lse = m + log l."""
    qf, kf = q.float(), k.float()
    bh, s, _ = q.shape
    m = torch.full((bh, s, 1), tfa._NEG_INF)
    l = torch.zeros((bh, s, 1))
    o = torch.zeros(q.shape)
    keep = tfa._keep(bh, s, seed, dropout, q.device) if dropout else None
    for k0 in range(0, s, 64):
        k1 = min(s, k0 + 64)
        sc = (qf @ kf[:, k0:k1].transpose(1, 2)) * scale
        if causal:
            sc = torch.where(torch.arange(s)[:, None]
                             >= torch.arange(k0, k1)[None, :], sc,
                             torch.tensor(tfa._NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if dropout:
            p = tfa._drop(p, keep[:, :, k0:k1], dropout)
        o = o * alpha + _split_product(p, v[:, k0:k1])
        m = m_new
    return o / l, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_split_forward_holds_the_jax_kernel_and_f64_plain_version(
        causal, dropout):
    """The bf16 forward kernel's arithmetic, emulated, at S = 96 (one
    whole 64-key tile and a tail): O against the JAX ``_flash_fwd``
    (interpret mode) on the same bf16 inputs and against ``_fwd_plain``
    summed in f64, under chip_smoke.py's bf16 rule, and before its
    rounding within 2**-12 of O's largest magnitude of the f64 sums (p in
    hi + lo pieces keeps it to ~2**-16 relative); lse within the F32
    tolerance of the JAX kernel's and the f64 one's."""
    s = 96
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in arrays(3, (BH, s, D), seed=11))
    jo, jl = jfa._flash_fwd(q, k, v, jnp.asarray([SEED], jnp.int32), SCALE,
                            causal, 32, 32, True, dropout)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (q, k, v))
    args = (SCALE, causal, dropout, SEED)
    o32, lse = _split_fwd(tq, tk, tv, *args)
    got = o32.to(torch.bfloat16)
    _hold_bf16(got, torch.from_numpy(np.array(jo.astype(jnp.float32))),
               "O vs JAX")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **F32)
    plain, _ = tfa._fwd_plain(tq, tk, tv, *args, acc=torch.float64)
    assert plain.dtype == torch.bfloat16
    _hold_bf16(got, plain, "O vs f64 plain")
    exact, exact_lse = tfa._fwd_plain(tq.double(), tk.double(), tv.double(),
                                      *args)
    err = float((o32.double() - exact).abs().max())
    assert err <= 2.0 ** -12 * float(exact.abs().max()), err
    np.testing.assert_allclose(lse.numpy(), exact_lse.numpy(), **F32)


# ----------------------------------------------------------- the kernels --
def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source, the shared
    ``*.cuh`` headers beside it and the flags: editing a header renames
    every library (so it rebuilds), editing a source only its own."""
    from mxnet_tpu_torch.ops import cuda as kcuda

    for name in ("a.cu", "b.cu", "common.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(kcuda, "SRC_DIR", tmp_path)
    monkeypatch.setattr(kcuda, "BUILD_DIR", tmp_path / "_build")

    def names():
        return {n: kcuda._lib_path(n)[1].name for n in ("a", "b")}
    first = names()
    assert first["a"] != first["b"] and first == names()
    (tmp_path / "common.cuh").write_text("// edited\n")
    second = names()
    assert all(second[n] != first[n] for n in first)
    (tmp_path / "a.cu").write_text("// a, edited\n")
    third = names()
    assert third["a"] != second["a"] and third["b"] == second["b"]
    (tmp_path / "more.cuh").write_text("// another header\n")
    assert all(names()[n] != third[n] for n in third)


def test_entry_points_take_the_seed_from_device_memory():
    """The three C entry points take the dropout seed as a pointer to an
    int32 on the card (a captured graph replays with the seed a device
    counter wrote), in ``KERNELS`` and in the source."""
    import ctypes
    import os

    from mxnet_tpu_torch.ops import cuda as kcuda

    src = open(os.path.join(kcuda.SRC_DIR, "flash_attention.cu")).read()
    for fn in ("flash_attention_fwd", "flash_attention_dq",
               "flash_attention_dkv"):
        args = kcuda.KERNELS["flash_attention"][fn]
        assert args[-2] is ctypes.c_void_p and args[-3] is ctypes.c_float
        decl = src[src.index(f'extern "C" int {fn}('):]
        decl = decl[:decl.index(")")]
        assert "const int* seed" in decl and "int seed" not in \
            decl.replace("const int* seed", "")


def test_cpu_runs_no_kernel():
    before = dict(flash_attention.launches)
    q, k, v = (x.requires_grad_(True) for x in t(*arrays(3, (2, 8, 64), 0)))
    flash_attention(q, k, v).sum().backward()
    assert flash_attention.launches == before


@pytest.mark.parametrize("what,shape,dtype,err", [
    ("dim", (2, 8, 32), torch.float32, ValueError),
    ("type", (2, 8, 64), torch.float16, TypeError),
    ("layout", (2, 8, 64), torch.float32, ValueError)])
def test_kernel_arguments_are_checked(what, shape, dtype, err):
    q = torch.zeros(shape, dtype=dtype)
    if what == "layout":
        q = torch.zeros((8, 2, 64)).transpose(0, 1)
    with pytest.raises(err):
        tfa._check_cuda("flash_attention_fwd", (q, q.clone(), q.clone()))
    ok = torch.zeros((2, 8, 64))
    with pytest.raises(TypeError, match="lse/delta"):
        tfa._check_cuda("flash_attention_dq", (ok, ok, ok, ok),
                        (torch.zeros(2, 8, dtype=torch.float64),
                         torch.zeros(2, 8)))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(ok, ok, torch.zeros((2, 9, 64)))
    # bf16 tiles come by TMA: a view 2 bytes past an aligned start raises
    flat = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    b = flat[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_cuda("flash_attention_dq", (b, b, b, b),
                        (torch.zeros(2, 8), torch.zeros(2, 8)))


gpu = pytest.mark.gpu


def _card_inputs(bh, s, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]


@gpu
@pytest.mark.parametrize("bh,s,d,dtype,causal,dropout", [
    (96, 128, 64, torch.bfloat16, False, 0.1),
    (24, 200, 64, torch.bfloat16, True, 0.1),
    (24, 256, 128, torch.bfloat16, False, 0.1),
    (37, 200, 128, torch.bfloat16, True, 0.0),
    (40, 200, 128, torch.bfloat16, True, 0.1),
    (37, 128, 64, torch.bfloat16, False, 0.1),
    (24, 200, 64, torch.float32, True, 0.1),
    (24, 512, 128, torch.float32, False, 0.0)])
def test_kernels_match_plain_versions_on_the_card(bh, s, d, dtype, causal,
                                                  dropout):
    q, k, v, do = _card_inputs(bh, s, d, dtype)
    args = (d ** -0.5, causal, dropout, SEED)
    o, lse = tfa._fwd_cuda(q, k, v, *args)
    delta = (o.float() * do.float()).sum(-1)
    got = [o, lse, tfa._dq_cuda(q, k, v, do, lse, delta, *args),
           *tfa._dkv_cuda(q, k, v, do, lse, delta, *args)]
    f64 = torch.float64
    po, plse = tfa._fwd_plain(q, k, v, *args, acc=f64)
    want = [po, plse, tfa._dq_plain(q, k, v, do, lse, delta, *args, acc=f64),
            *tfa._dkv_plain(q, k, v, do, lse, delta, *args, acc=f64)]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        # f32 outputs (lse among them) within 1e-4 of their scale; an
        # output stored in bf16 may round to the neighbouring value
        rtol = 2 ** -6 if a.dtype == torch.bfloat16 else 1e-4
        a, b = a.double(), b.double()
        assert bool(((a - b).abs() <= rtol * (b.abs().max() + b.abs()))
                    .all())


@gpu
@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_backward_kernels_repeat_their_bits_on_the_card(d, causal):
    """No atomics: two launches of each bf16 backward kernel on the same
    inputs give the same bits (S = 200: a tail)."""
    q, k, v, do = _card_inputs(37, 200, d, torch.bfloat16)
    args = (d ** -0.5, causal, 0.1, SEED)
    o, lse = tfa._fwd_cuda(q, k, v, *args)
    delta = (o.float() * do.float()).sum(-1)
    runs = [(tfa._dq_cuda(q, k, v, do, lse, delta, *args),
             *tfa._dkv_cuda(q, k, v, do, lse, delta, *args))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
