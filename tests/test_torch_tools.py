"""The port's tools (``mxnet_tpu_torch/tools``: ``im2rec``, ``bandwidth``)
against the JAX package's (``tools/im2rec.py``, ``tools/bandwidth.py``)
on the CPU.

- ``python -m mxnet_tpu_torch.tools.im2rec`` writes the ``.lst``,
  ``.rec`` and ``.idx`` files of ``tools/im2rec.py``, byte for byte,
  for the same seeded PNG folder (JPEG records, resized raw records, a
  train/val split of the list), and the port's ``io.ImageRecordIter``
  reads them as the JAX one does.
- ``bandwidth --device cpu`` gives the JAX sweep's rows (the same keys
  and sizes); each row holds its pulls to the pushed sums exactly, so a
  store that pulls a wrong value fails the row; under the launcher a
  ``dist_sync`` store's pulls are the gang's sums.
- Neither tool imports ``jax`` or ``mxnet_tpu``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu import io as jio
from mxnet_tpu_torch import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(args, timeout=120):
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, cwd=REPO, env=_env())
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    return proc.stdout


def _img_tree(root, n_classes=3, per_class=4):
    """A seeded folder of PNGs, one subfolder a class, sizes differing."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = (rng.rand(36 + 2 * c, 44 + i, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.png"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("im2rec") / "imgs")
    _img_tree(root)
    return root


@pytest.mark.parametrize("flags", ([], ["--resize", "24", "--raw"],
                                   ["--no-shuffle", "--quality", "80"]),
                         ids=("jpeg", "raw", "unshuffled"))
def test_im2rec_writes_the_jax_tools_bytes(tree, tmp_path, flags):
    jax_prefix, port_prefix = str(tmp_path / "jax"), str(tmp_path / "port")
    list_flags = [f for f in flags if f == "--no-shuffle"]
    _run([os.path.join(REPO, "tools", "im2rec.py"), "--list", jax_prefix,
          tree] + list_flags)
    _run(["-m", "mxnet_tpu_torch.tools.im2rec", "--list", port_prefix,
          tree] + list_flags)
    assert _bytes(jax_prefix + ".lst") == _bytes(port_prefix + ".lst")
    _run([os.path.join(REPO, "tools", "im2rec.py"), jax_prefix, tree]
         + flags)
    out = _run(["-m", "mxnet_tpu_torch.tools.im2rec", port_prefix, tree]
               + flags)
    assert "packed 12 images" in out
    for ext in (".rec", ".idx"):
        assert _bytes(jax_prefix + ext) == _bytes(port_prefix + ext), ext


def test_im2rec_train_val_split_as_jax(tree, tmp_path):
    from tools import im2rec as jim2rec
    from mxnet_tpu_torch.tools import im2rec as tim2rec
    jim2rec.make_list(str(tmp_path / "j"), tree, train_ratio=0.75)
    tim2rec.make_list(str(tmp_path / "t"), tree, train_ratio=0.75)
    for part in ("_train.lst", "_val.lst"):
        assert _bytes(str(tmp_path / "j") + part) == \
            _bytes(str(tmp_path / "t") + part)
    assert len(list(tim2rec.read_list(str(tmp_path / "t_val.lst")))) == 3


def _collect(it):
    return [([d.asnumpy() for d in b.data],
             [lab.asnumpy() for lab in (b.label or [])], b.pad) for b in it]


@pytest.mark.parametrize("raw", (False, True), ids=("jpeg", "raw"))
def test_image_record_iter_reads_the_ports_records_as_jax(tree, tmp_path,
                                                          raw):
    from mxnet_tpu_torch.tools import im2rec as tim2rec
    prefix = str(tmp_path / "data")
    tim2rec.pack(prefix, tree, resize=32 if raw else 0, raw=raw)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 28, 28),
              batch_size=5, shuffle=True, rand_mirror=True, seed=3)
    with tmx.cpu():
        port = _collect(tio.ImageRecordIter(**kw))
    jax_side = _collect(jio.ImageRecordIter(**kw))
    assert len(port) == len(jax_side) == 3
    for (dp, lp, pp), (dj, lj, pj) in zip(port, jax_side):
        assert pp == pj
        for a, b in zip(dp + lp, dj + lj):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    labels = np.concatenate([lab[0] for _, lab, _ in port])
    assert set(labels.astype(int).tolist()) == {0, 1, 2}


SIZES = (1000, 20000)


def test_bandwidth_rows_as_jax():
    from tools import bandwidth as jbw
    from mxnet_tpu_torch.tools import bandwidth as tbw
    jrows = jbw.measure("device", SIZES, repeat=2)
    trows = tbw.measure("device", SIZES, repeat=2, device="cpu")
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [(r["size"], r["bytes"]) for r in trows] == \
        [(r["size"], r["bytes"]) for r in jrows]
    assert all(r["avg_roundtrip_ms"] > 0 and r["GB_per_s"] > 0
               for r in trows)


def test_bandwidth_cli_json_rows():
    out = _run(["-m", "mxnet_tpu_torch.tools.bandwidth", "--device", "cpu",
                "--sizes", "1e3,2e4", "--repeat", "3", "--json"])
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["size"] for r in rows] == list(SIZES)
    assert all(set(r) == {"size", "bytes", "avg_roundtrip_ms", "GB_per_s"}
               for r in rows)


def test_bandwidth_row_fails_on_a_wrong_pull(monkeypatch):
    """A pull that is off by one element's ulp fails its row: the rows
    hold each pull to the pushed sum exactly."""
    from mxnet_tpu_torch.kvstore.kvstore import KVStore
    from mxnet_tpu_torch.tools import bandwidth as tbw
    real = KVStore.pull

    def off_by_a_bit(self, key, out=None, **kw):
        real(self, key, out=out, **kw)
        out._data[7] += 1.0
    monkeypatch.setattr(KVStore, "pull", off_by_a_bit)
    with pytest.raises(AssertionError, match="disagrees with the pushed"):
        tbw.measure("device", (1000,), repeat=2, device="cpu")


def test_bandwidth_dist_store_over_a_gang():
    """``dist_sync`` under ``python -m mxnet_tpu_torch.launch -n 2``:
    every pull is the gang's sum (the row checks it) and rank 0 prints
    the rows."""
    out = _run(["-m", "mxnet_tpu_torch.launch", "-n", "2", "--platform",
                "cpu", sys.executable, "-m",
                "mxnet_tpu_torch.tools.bandwidth", "--device", "cpu",
                "--kvstore", "dist_sync", "--sizes", "1e3,2e4", "--json"],
               timeout=180)
    rows = [json.loads(ln.split("] ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("[r") and "{" in ln]
    assert [r["size"] for r in rows] == list(SIZES)


def test_bandwidth_chain_stays_exact_at_any_world(monkeypatch):
    """The chained pushes stay float32's exact integers at the default
    repeat over a merge of 4 (and 3, not a power of two), and each row's
    last pull is the world times the last push."""
    from mxnet_tpu_torch.tools import bandwidth as tbw

    pulls = []
    check = tbw._check

    def spy(out, want, key, what):
        pulls.append(want)
        check(out, want, key, what)

    class Merging:                  # a dist store's merge of `world`
        def __init__(self, world):
            self.world, self.rank, self.type = world, 0, "dist_sync"
            self.num_workers = world
            self.store = {}

        def init(self, key, value):
            self.store[key] = value.asnumpy()

        def push(self, key, value):
            self.store[key] = value.asnumpy() * self.world

        def pull(self, key, out):
            out[:] = self.store[key]

    monkeypatch.setattr(tbw, "_check", spy)
    for world in (3, 4):
        monkeypatch.setattr(tmx.kv, "create", lambda _t, w=world: Merging(w))
        pulls.clear()
        rows = tbw.measure("dist_sync", (1000,), repeat=10, device="cpu")
        assert [r["size"] for r in rows] == [1000]
        first = pulls[0] / world
        np.testing.assert_array_equal(pulls[-1], (first + 11) * world)


def test_bandwidth_device_cuda_raises_without_a_card():
    proc = subprocess.run([sys.executable, "-m",
                           "mxnet_tpu_torch.tools.bandwidth", "--sizes",
                           "1e3"], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=_env())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "size" not in proc.stdout


def test_tools_import_neither_jax_nor_the_jax_package(tmp_path):
    """The tools run with ``jax`` and ``mxnet_tpu`` unimportable (a
    poisoned path entry) and load neither."""
    poison = tmp_path / "poison"
    for name in ("jax", "mxnet_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} imported')\n")
    _img_tree(str(tmp_path / "imgs"), n_classes=1, per_class=2)
    code = (
        "import sys\n"
        "from mxnet_tpu_torch.tools import bandwidth, chaos_check, im2rec\n"
        f"im2rec.pack({str(tmp_path / 'p')!r}, {str(tmp_path / 'imgs')!r})\n"
        "bandwidth.measure('device', (100,), repeat=1, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = _env()
    env["PYTHONPATH"] = str(poison) + os.pathsep + env["PYTHONPATH"]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
