"""``mx.image``, the native JPEG decoder's augmentation and the 30 op
names this slice registers (``mxnet_tpu_torch/image.py``,
``io.AugSpec``, ``ops/image.py``, ``ops/attention.py``,
``ops/paged_attention.py``) against the JAX package's: the cases of
``tests/test_image.py`` and ``tests/test_image_native_aug.py`` on the
port, the registry census (252 + 30 = 282 names, 307 with the RNN,
sequence and multibox ops), each new name's
output against JAX's (float32 within 1e-5; ``image_resize`` of uint8
within 1 on every pixel), and the random ops and ``Dropout`` held by
their invariants (the port draws from torch generators, not threefry
keys).
"""
import ctypes
import importlib.util
import io as _pyio
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import io as jio
from mxnet_tpu.ops.registry import OPS as JOPS
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import image, recordio
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.ops.registry import OPS as TOPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=0, atol=1e-5)


# ---------------------------------------------------------------- mx.image --
@pytest.fixture()
def png_bytes():
    from PIL import Image
    arr = np.random.RandomState(0).randint(0, 255, (48, 64, 3), np.uint8)
    buf = _pyio.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue(), arr


def test_imdecode_shapes_and_grayscale(png_bytes):
    raw, arr = png_bytes
    with tmx.cpu():
        img = image.imdecode(raw)
        assert img.shape == (48, 64, 3)
        np.testing.assert_array_equal(img.asnumpy(), arr)
        gray = image.imdecode(raw, flag=0)
        np.testing.assert_array_equal(
            gray.asnumpy(), jmx.image.imdecode(raw, flag=0).asnumpy())
        bgr = image.imdecode(raw, to_rgb=False)
        np.testing.assert_array_equal(bgr.asnumpy(), arr[..., ::-1])


def test_imread_and_resize(tmp_path, png_bytes):
    raw, arr = png_bytes
    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(raw)
    with tmx.cpu():
        img = image.imread(p)
        assert img.shape == (48, 64, 3)
        small = image.imresize(img, 32, 24)
        np.testing.assert_array_equal(
            small.asnumpy(),
            jmx.image.imresize(jmx.nd.array(arr), 32, 24).asnumpy())
        short = image.resize_short(img, 24)
        assert min(short.shape[:2]) == 24


def test_crops(png_bytes):
    _, arr = png_bytes
    with tmx.cpu():
        img = tmx.nd.array(arr)
        fixed = image.fixed_crop(img, 4, 2, 16, 12)
        np.testing.assert_array_equal(fixed.asnumpy(), arr[2:14, 4:20])
        c, (x0, y0, w, h) = image.center_crop(img, (32, 32))
        assert c.shape == (32, 32, 3) and w == 32 and h == 32
        r, box = image.random_crop(img, (16, 16),
                                   rng=np.random.RandomState(1))
        jr, jbox = jmx.image.random_crop(jmx.nd.array(arr), (16, 16),
                                         rng=np.random.RandomState(1))
        assert box == jbox
        np.testing.assert_array_equal(r.asnumpy(), jr.asnumpy())


def test_color_normalize(png_bytes):
    _, arr = png_bytes
    with tmx.cpu():
        out = image.color_normalize(tmx.nd.array(arr.astype(np.float32)),
                                    mean=np.array([1.0, 2.0, 3.0], np.float32),
                                    std=np.array([2.0, 2.0, 2.0], np.float32))
        np.testing.assert_allclose(
            out.asnumpy(), (arr.astype(np.float32) - [1, 2, 3]) / 2.0,
            rtol=1e-6)


def test_augmenter_list_and_dumps_match_jax():
    kw = dict(resize=28, rand_mirror=True, mean=True, std=True,
              brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1,
              pca_noise=0.05)
    augs = image.CreateAugmenter((3, 24, 24), **kw)
    jaugs = jmx.image.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in augs] == \
        [type(a).__name__ for a in jaugs]
    assert [a.dumps() for a in augs] == [a.dumps() for a in jaugs]
    img = np.random.RandomState(0).randint(0, 255, (40, 50, 3), np.uint8)
    np.random.seed(3)
    with tmx.cpu():
        out = tmx.nd.array(img)
        for a in augs:
            out = a(out)
        out = out.asnumpy()
    np.random.seed(3)
    want = jmx.nd.array(img)
    for a in jaugs:
        want = a(want)
    assert out.shape == (24, 24, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, want.asnumpy(), rtol=1e-5, atol=1e-4)


def _png_list(tmp_path, n, hw=36):
    from PIL import Image
    rng = np.random.RandomState(0)
    imglist = []
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (hw, hw, 3), np.uint8)) \
            .save(str(tmp_path / f"im{i}.png"))
        imglist.append([i % 3, f"im{i}.png"])
    return imglist


def test_image_iter_imglist_mode(tmp_path):
    imglist = _png_list(tmp_path, 6)
    with tmx.cpu():
        it = image.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                             imglist=imglist, path_root=str(tmp_path))
        batch = next(it)
        assert batch.data[0].shape == (4, 3, 24, 24)
        assert batch.label[0].shape == (4,)
        assert next(it).pad == 2
        with pytest.raises(StopIteration):
            next(it)
        jit = jmx.image.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                                  imglist=imglist, path_root=str(tmp_path))
        np.testing.assert_array_equal(batch.data[0].asnumpy(),
                                      next(jit).data[0].asnumpy())


def test_image_iter_record_mode(tmp_path):
    from PIL import Image
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(8):
        buf = _pyio.BytesIO()
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)) \
            .save(buf, format="JPEG")
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 4), i, 0),
                                     buf.getvalue()))
    w.close()
    with tmx.cpu():
        it = image.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                             path_imgrec=rec, path_imgidx=idx, shuffle=True)
        batches = list(it)
    assert len(batches) == 2
    assert batches[0].data[0].shape == (4, 3, 32, 32)
    it.close()


def test_image_iter_dataset_smaller_than_batch(tmp_path):
    imglist = _png_list(tmp_path, 2)
    with tmx.cpu():
        it = image.ImageIter(batch_size=8, data_shape=(3, 24, 24),
                             imglist=imglist, path_root=str(tmp_path))
        b = next(it)
    assert b.data[0].shape == (8, 3, 24, 24) and b.pad == 6


# ---------------------------------------------------- native augmentation --
_spec = importlib.util.spec_from_file_location(
    "_native_aug_oracle", os.path.join(REPO, "tests",
                                       "test_image_native_aug.py"))
_oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_oracle)


def _port_native(blob, out_h, out_w, resize, rand_crop, rand_mirror, seed,
                 aug):
    lib = tio._native_decoder()
    assert lib is not None, tmx.base.native_status().get("libimagedecode")
    ptrs = (ctypes.c_char_p * 1)(blob)
    out = np.empty((3, out_h, out_w), np.uint8)
    ok = np.empty((1,), np.uint8)
    arr = aug.to_array()
    n = lib.mxtpu_decode_batch_aug(
        ptrs, (ctypes.c_long * 1)(len(blob)), 1, out_h, out_w, resize,
        (ctypes.c_int * 1)(-2 if rand_crop else -1),
        (ctypes.c_int * 1)(-2 if rand_crop else -1),
        (ctypes.c_uint8 * 1)(2 if rand_mirror else 0),
        (ctypes.c_uint32 * 1)(seed),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 1)
    assert n == 1 and ok[0] == 1
    return out


@pytest.mark.parametrize("seed", [1, 7, 123456, 2 ** 31 - 5])
def test_full_chain_parity(seed):
    """rrc geometry and every colour augmentation: the port's decoder
    gives the JAX package's bits, and is within 2 of the oracle."""
    blob = _oracle._jpeg(96, 80, seed % 7)
    aug = tio.AugSpec(**_oracle.FULL)
    nat = _port_native(blob, 64, 64, 0, True, True, seed, aug)
    jnat = _oracle.native_process(blob, 64, 64, 0, True, True, seed,
                                  jio.AugSpec(**_oracle.FULL))
    np.testing.assert_array_equal(nat, jnat)
    ora = _oracle.oracle_process(blob, 64, 64, 0, True, True, seed, aug)
    diff = np.abs(nat.astype(np.int32) - ora.astype(np.int32))
    assert diff.max() <= 2 and (diff > 0).mean() < 0.05


@pytest.mark.parametrize("key", ["brightness", "contrast", "saturation",
                                 "hue", "pca_noise"])
def test_single_aug_parity(key):
    blob = _oracle._jpeg(64, 64, 3)
    kw = {key: 0.5 if key != "pca_noise" else 0.15}
    nat = _port_native(blob, 64, 64, 0, False, False, 99, tio.AugSpec(**kw))
    ora = _oracle.oracle_process(blob, 64, 64, 0, False, False, 99,
                                 tio.AugSpec(**kw))
    assert np.abs(nat.astype(np.int32) - ora.astype(np.int32)).max() <= 2
    np.testing.assert_array_equal(
        tio.AugSpec(**kw).to_array(), jio.AugSpec(**kw).to_array())


def test_geometry_only_matches_the_plain_entry_point():
    lib = tio._native_decoder()
    blob = _oracle._jpeg(90, 70, 5)
    args = ((ctypes.c_char_p * 1)(blob), (ctypes.c_long * 1)(len(blob)), 1,
            48, 48, 0, (ctypes.c_int * 1)(-2), (ctypes.c_int * 1)(-2),
            (ctypes.c_uint8 * 1)(2), (ctypes.c_uint32 * 1)(424242))
    a = np.empty((3, 48, 48), np.uint8)
    b = np.empty((3, 48, 48), np.uint8)
    ok = np.empty((1,), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.mxtpu_decode_batch(*args, a.ctypes.data_as(u8),
                           ok.ctypes.data_as(u8), 1)
    assert ok[0] == 1
    lib.mxtpu_decode_batch_aug(*args, None, b.ctypes.data_as(u8),
                               ok.ctypes.data_as(u8), 1)
    assert ok[0] == 1
    np.testing.assert_array_equal(a, b)


def test_record_iter_color_args_native(tmp_path):
    """The reference's colour and rrc options stay on the native route,
    are seed-deterministic, augment, and give the JAX package's bits."""
    rec, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(8):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 3), i, 0),
                                     _oracle._jpeg(80, 72, i)))
    w.close()
    kw = dict(data_shape=(3, 48, 48), batch_size=4, rand_crop=True,
              rand_mirror=True, random_resized_crop=True,
              min_random_area=0.3, random_h=36, random_s=64, random_l=50,
              max_random_contrast=0.3, pca_noise=0.05, seed=11,
              use_native_decode=True)
    with tmx.cpu():
        it1 = tio.ImageRecordIter(rec, path_imgidx=idx, **kw)
        b1 = [it1.next().data[0].asnumpy() for _ in range(2)]
        it2 = tio.ImageRecordIter(rec, path_imgidx=idx, **kw)
        b2 = [it2.next().data[0].asnumpy() for _ in range(2)]
        it3 = tio.ImageRecordIter(rec, path_imgidx=idx,
                                  data_shape=(3, 48, 48), batch_size=4,
                                  rand_crop=True, rand_mirror=True, seed=11,
                                  use_native_decode=True)
        b3 = it3.next().data[0].asnumpy()
    jit = jio.ImageRecordIter(rec, path_imgidx=idx, **kw)
    jb = [jit.next().data[0].asnumpy() for _ in range(2)]
    for x, y, z in zip(b1, b2, jb):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert np.abs(b1[0] - b3).max() > 1


# ------------------------------------------------------------ the registry --
NEW_NAMES = {
    "image": ["image_resize", "resize", "image_normalize", "normalize",
              "image_to_tensor", "to_tensor", "image_crop", "crop",
              "image_flip_left_right", "flip_left_right",
              "image_flip_top_bottom", "flip_top_bottom",
              "image_random_flip_left_right", "random_flip_left_right",
              "image_random_brightness", "random_brightness",
              "image_random_contrast", "random_contrast"],
    "attention": ["interleaved_matmul_selfatt_qk",
                  "_contrib_interleaved_matmul_selfatt_qk",
                  "interleaved_matmul_selfatt_valatt",
                  "_contrib_interleaved_matmul_selfatt_valatt",
                  "multi_head_attention", "flash_attention", "div_sqrt_dim",
                  "_contrib_div_sqrt_dim", "ring_attention",
                  "ulysses_attention"],
    "paged_attention": ["paged_decode_attention", "dense_decode_attention"],
}


def test_registry_census():
    """The port's registry is the JAX one's whole: 348 of 348 names (the
    input pipeline's 30 among them, the 25 of ``ops.rnn``,
    ``ops.sequence`` and ``ops.multibox``, the symbol frontend's
    ``_scalar``, the 39 of ``ops.random_ops``, ``ops.quantization`` and
    ``ops.control_flow``, and ``parallel.moe``'s ``moe_ffn``)."""
    new = [n for names in NEW_NAMES.values() for n in names]
    assert len(new) == len(set(new)) == 30
    assert set(new) <= set(TOPS) and set(new) <= set(JOPS)
    assert set(TOPS) <= set(JOPS)
    assert len(TOPS) == 348 and len(JOPS) == 348
    missing = {JOPS[n].__module__.split(".", 1)[1]
               for n in set(JOPS) - set(TOPS)}
    assert missing == set()
    for n in new:
        assert hasattr(tmx.nd, n), n


def _img(shape, seed=0, kind="u8"):
    rng = np.random.RandomState(seed)
    if kind == "u8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(np.float32)


RESIZE_CASES = {
    "u8 down": ((30, 40, 3), "u8", dict(size=(17, 11))),
    "u8 up": ((12, 10, 3), "u8", dict(size=(25, 31))),
    "f32 down": ((30, 40, 3), "f32", dict(size=(13, 9))),
    "f32 up": ((12, 10, 3), "f32", dict(size=(25, 31))),
    "f32 down, batch": ((2, 30, 40, 3), "f32", dict(size=(20, 15))),
    "int size": ((30, 40, 3), "f32", dict(size=16)),
    "keep_ratio wide": ((30, 40, 3), "f32", dict(size=16, keep_ratio=True)),
    "keep_ratio tall": ((40, 30, 3), "u8", dict(size=24, keep_ratio=True)),
    "one axis": ((30, 40, 3), "f32", dict(size=(40, 20))),
    "nearest down": ((30, 40, 3), "u8", dict(size=(17, 11), interp=0)),
    "nearest up": ((12, 10, 1), "f32", dict(size=(25, 31), interp=0)),
}


@pytest.mark.parametrize("name", ["image_resize", "resize"])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_image_resize_matches_jax(name, case):
    """``jax.image.resize``'s function (antialiased on downscale,
    half-pixel centres; uint8 rounded and clipped): float32 within 1e-5
    on [0, 1] inputs, uint8 within 1 on every pixel."""
    shape, kind, kw = RESIZE_CASES[case]
    x = _img(shape, 1, kind)
    want = getattr(jmx.nd, name)(jmx.nd.array(x, dtype=x.dtype), **kw)
    with tmx.cpu():
        got = getattr(tmx.nd, name)(tmx.nd.array(x, dtype=x.dtype), **kw)
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "u8":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, **F32)


def _pair(op, *args, **kw):
    with tmx.cpu():
        t = getattr(tmx.nd, op)(*[tmx.nd.array(a, dtype=a.dtype)
                                  for a in args], **kw)
    j = getattr(jmx.nd, op)(*[jmx.nd.array(a, dtype=a.dtype) for a in args],
                            **kw)
    return t.asnumpy(), j.asnumpy()


DETERMINISTIC = {
    "image_normalize": (lambda: [_img((3, 8, 6), 2, "f32")],
                        dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.25, 2.0))),
    "normalize": (lambda: [_img((2, 3, 8, 6), 2, "f32")],
                  dict(mean=0.5, std=0.25)),
    "image_to_tensor": (lambda: [_img((8, 6, 3), 3)], {}),
    "to_tensor": (lambda: [_img((2, 8, 6, 3), 3)], {}),
    "image_crop": (lambda: [_img((8, 6, 3), 4)],
                   dict(x=1, y=2, width=3, height=4)),
    "crop": (lambda: [_img((2, 8, 6, 3), 4, "f32")],
             dict(x=2, y=1, width=4, height=5)),
    "image_flip_left_right": (lambda: [_img((8, 6, 3), 5)], {}),
    "flip_left_right": (lambda: [_img((2, 8, 6, 3), 5, "f32")], {}),
    "image_flip_top_bottom": (lambda: [_img((8, 6, 3), 6)], {}),
    "flip_top_bottom": (lambda: [_img((2, 8, 6, 3), 6, "f32")], {}),
    "interleaved_matmul_selfatt_qk": (
        lambda: [_img((5, 2, 3 * 3 * 4), 7, "f32")], dict(heads=3)),
    "_contrib_interleaved_matmul_selfatt_qk": (
        lambda: [_img((5, 2, 2 * 3 * 4), 7, "f32")], dict(heads=2)),
    "interleaved_matmul_selfatt_valatt": (
        lambda: [_img((5, 2, 3 * 3 * 4), 8, "f32"),
                 _img((6, 5, 5), 9, "f32")], dict(heads=3)),
    "_contrib_interleaved_matmul_selfatt_valatt": (
        lambda: [_img((5, 2, 2 * 3 * 4), 8, "f32"),
                 _img((4, 5, 5), 9, "f32")], dict(heads=2)),
    "div_sqrt_dim": (lambda: [_img((3, 16), 10, "f32")], {}),
    "_contrib_div_sqrt_dim": (lambda: [_img((2, 3, 9), 10, "f32")], {}),
    "multi_head_attention": (
        lambda: [_img((2, 6, 12), s, "f32") for s in (11, 12, 13)],
        dict(heads=3, causal=True)),
    "dense_decode_attention": (
        lambda: [_img((3, 2, 4), 14, "f32"), _img((3, 10, 2, 4), 15, "f32"),
                 _img((3, 10, 2, 4), 16, "f32"),
                 np.array([10, 3, 7], np.int32)], {}),
}


@pytest.mark.parametrize("op", sorted(DETERMINISTIC))
def test_new_names_match_jax(op):
    args, kw = DETERMINISTIC[op]
    t, j = _pair(op, *args(), **kw)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, **F32)


def test_paged_decode_attention_name_matches_jax():
    rng = np.random.RandomState(17)
    slots, heads, d, page, pps = 3, 2, 8, 4, 3
    q = rng.randn(slots, heads, d).astype(np.float32)
    kp = rng.randn(1 + slots * pps, page, heads, d).astype(np.float32)
    vp = rng.randn(1 + slots * pps, page, heads, d).astype(np.float32)
    tables = (1 + np.arange(slots * pps)).reshape(slots, pps).astype(np.int32)
    lengths = np.array([12, 5, 1], np.int32)
    args = (q, kp, vp, tables, lengths)
    for impl in (None, "jnp"):
        t, j = _pair("paged_decode_attention", *args, impl=impl)
        np.testing.assert_allclose(t, j, **F32)
    with pytest.raises(ValueError, match="impl"):
        _pair("paged_decode_attention", *args, impl="bogus")


def test_flash_attention_name_matches_jax_with_gradients():
    """``nd.flash_attention`` under ``record()``: the output and the
    gradients of q, k, v against the JAX op's (Pallas in interpret mode
    on the CPU)."""
    b, s, h, d = 2, 32, 3, 8
    rng = np.random.RandomState(18)
    q, k, v, w = (rng.randn(b, s, h * d).astype(np.float32)
                  for _ in range(4))
    jx = [jmx.nd.array(x) for x in (q, k, v)]
    for x in jx:
        x.attach_grad()
    with jag.record():
        jo = jmx.nd.flash_attention(*jx, heads=h, block_q=16, block_k=16)
        (jo * jmx.nd.array(w)).sum().backward()
    with tmx.cpu():
        tx = [tmx.nd.array(x) for x in (q, k, v)]
        for x in tx:
            x.attach_grad()
        with tag.record():
            to = tmx.nd.flash_attention(*tx, heads=h)
            (to * tmx.nd.array(w)).sum().backward()
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), **F32)
    for a, bb in zip(tx, jx):
        np.testing.assert_allclose(a.grad.asnumpy(), bb.grad.asnumpy(), **F32)


@pytest.mark.parametrize("op", ["ring_attention", "ulysses_attention"])
def test_mesh_attention_names_raise_naming_a15(op):
    """Ported in A15b: outside a mesh the op raises as JAX's does; over a
    mesh whose ``sp`` axis has one rank it is the dense attention
    (``tests/test_torch_sequence_parallel.py`` runs it over two)."""
    x = np.random.RandomState(3).randn(1, 4, 8).astype(np.float32)
    with pytest.raises(ValueError, match="needs a mesh"):
        getattr(jmx.nd, op)(*[jmx.nd.array(x)] * 3, heads=2)
    with tmx.cpu():
        with pytest.raises(ValueError, match="needs a mesh"):
            getattr(tmx.nd, op)(*[tmx.nd.array(x)] * 3, heads=2)
        with tmx.parallel.MeshScope(tmx.parallel.make_mesh(sp=1)):
            got = getattr(tmx.nd, op)(*[tmx.nd.array(x)] * 3, heads=2)
        want = tmx.nd.multi_head_attention(*[tmx.nd.array(x)] * 3, heads=2)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32)


# ---------------------------------------------------- random: invariants --
@pytest.mark.parametrize("op", ["image_random_flip_left_right",
                                "random_flip_left_right"])
def test_random_flip_is_the_input_or_its_flip(op):
    x = _img((2, 6, 5, 3), 19)
    seen = set()
    with tmx.cpu():
        tmx.random.seed(1)
        for _ in range(16):
            out = getattr(tmx.nd, op)(tmx.nd.array(x, dtype="uint8")) \
                .asnumpy()
            if np.array_equal(out, x):
                seen.add("same")
            else:
                np.testing.assert_array_equal(out, x[..., ::-1, :])
                seen.add("flipped")
    assert seen == {"same", "flipped"}


@pytest.mark.parametrize("op", ["image_random_brightness",
                                "random_brightness"])
def test_random_brightness_factor_in_range(op):
    x = _img((6, 5, 3), 20, "f32") + 0.1
    with tmx.cpu():
        for _ in range(8):
            out = getattr(tmx.nd, op)(tmx.nd.array(x), min_factor=0.6,
                                      max_factor=1.3).asnumpy()
            f = out / x
            assert np.allclose(f, f.flat[0], rtol=1e-6)
            assert 0.6 <= f.flat[0] < 1.3


@pytest.mark.parametrize("op", ["image_random_contrast", "random_contrast"])
def test_random_contrast_factor_in_range(op):
    x = _img((6, 5, 3), 21, "f32")
    mean = x.mean(axis=(0, 1), keepdims=True)
    with tmx.cpu():
        for _ in range(8):
            out = getattr(tmx.nd, op)(tmx.nd.array(x), min_factor=0.5,
                                      max_factor=1.5).asnumpy()
            f = (out - mean) / (x - mean)
            assert np.allclose(f, np.median(f), rtol=1e-3, atol=1e-3)
            assert 0.5 - 1e-6 <= np.median(f) < 1.5


def test_dropout_and_mha_dropout_hold_their_invariants():
    """Registered ``Dropout`` and ``multi_head_attention``'s dropout draw
    from torch generators: each output element is 0 or the input over
    the keep rate; off in inference mode, the JAX op's numbers."""
    x = _img((64, 64), 22, "f32") + 0.5
    with tmx.cpu():
        tmx.random.seed(2)
        with tag.train_mode():
            out = tmx.nd.Dropout(tmx.nd.array(x), p=0.25).asnumpy()
        kept = out != 0
        np.testing.assert_allclose(out[kept], x[kept] / 0.75, rtol=1e-6)
        assert 0.65 < kept.mean() < 0.85
        q, k, v = (_img((2, 6, 12), s, "f32") for s in (23, 24, 25))
        args = [tmx.nd.array(a) for a in (q, k, v)]
        a1 = tmx.nd.multi_head_attention(*args, heads=3, dropout=0.5,
                                         training=True).asnumpy()
        a2 = tmx.nd.multi_head_attention(*args, heads=3, dropout=0.5,
                                         training=True).asnumpy()
        off = tmx.nd.multi_head_attention(*args, heads=3, dropout=0.5,
                                          training=False).asnumpy()
    assert np.isfinite(a1).all() and not np.array_equal(a1, a2)
    want = jmx.nd.multi_head_attention(*[jmx.nd.array(a) for a in (q, k, v)],
                                       heads=3, dropout=0.5,
                                       training=False).asnumpy()
    np.testing.assert_allclose(off, want, **F32)
