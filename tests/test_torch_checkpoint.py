"""Port parity: ``mxnet_tpu_torch.parallel.checkpoint`` against the JAX
package's ``parallel/checkpoint.py`` — the v1.1 snapshot format, on the
CPU.

The cases of ``tests/test_checkpoint.py`` and
``tests/test_checkpoint_durability.py`` on the port's ``TrainStep``
(the sharded v2 format's gang cases and the mesh cases are in
``tests/test_torch_checkpoint_sharded.py``; here the world of one's v2
round trip and the refusal of an orbax directory), plus what only the
port has to show:

- cross-load: a float32 snapshot written by either package verifies and
  loads in the other, and both then take 3 more steps to the same losses
  and weights (rtol 1e-5 / atol 1e-6: the same state, the packages'
  forward and backward summing in another order); a snapshot loaded and
  written again by the other package has the same entries, sizes and
  crc32 digests (the same bytes), bfloat16 entries included;
- a bfloat16 snapshot written by the JAX package loads in the port,
  bit for bit — while the JAX package cannot load it itself
  (``np.load`` gives its bfloat16 entries as ``V2``, which JAX refuses;
  ROADMAP C7);
- a load writes into the step's own tensors (the ones a captured graph
  holds) and never rebinds one;
- the damage cases against the reference's verdicts: one snapshot (or
  directory of snapshots), written by either package and damaged once,
  goes through both packages' ``verify_checkpoint``,
  ``load_snapshot_params``, ``load_train_step`` and ``resume_latest``,
  which raise the same exception class or restore the same step and
  the same bytes.

Trajectory checks within one package are bit-exact (the same code on
the same inputs).
"""
import gc
import io
import json
import logging
import os
import shutil
import threading
import time
import zipfile
import zlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fault as jfault
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.parallel import checkpoint as jck

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fault, gluon, parallel, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import checkpoint as ck
from mxnet_tpu_torch.parallel.checkpoint import (
    AsyncSnapshotter, BitFlipInjection, CheckpointCorruptError,
    CheckpointManager, CheckpointMismatchError, FORMAT_VERSION,
    flush_pending, list_checkpoints, load_snapshot_params, load_train_step,
    resume_latest, save_train_step, verify_checkpoint)

_MANIFEST_MEMBER = "__manifest__.npy"
GAUGES = ("ckpt_last_snapshot_ms", "ckpt_bytes", "ckpt_pending_writes",
          "ckpt_verify_failures", "ckpt_snapshots_skipped")
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
CROSS = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def _net(seed):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.BatchNorm(in_channels=16),
            nn.Dense(4, in_units=16))
    net.initialize(ctx="cpu")
    return net


def _step_for(net, opt_name="adam", **opt_kw):
    return parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mx.optimizer.create(opt_name, **opt_kw))


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(16, 8).astype(np.float32),
             rng.randint(0, 4, (16,)).astype(np.int32)) for _ in range(n)]


def _host(step):
    """Every tensor of the step (params, states, aux) on the host."""
    return [t.detach().clone() for t in
            step._train + [s for st in step._states for s in st] + step._aux]


# ------------------------------------------------------ kill and resume --
def test_kill_and_resume_identical_trajectory(tmp_path):
    f = str(tmp_path / "ckpt.npz")
    batches = _batches(8)
    step = _step_for(_net(7))
    ref = [float(step(x, y)) for x, y in batches]

    step1 = _step_for(_net(7))
    for x, y in batches[:4]:
        step1(x, y)
    save_train_step(step1, f)
    del step1

    step2 = _step_for(_net(99))          # different init — must not matter
    step2(*batches[0])                   # build (runs one step)
    load_train_step(step2, f)
    resumed = [float(step2(x, y)) for x, y in batches[4:]]
    assert resumed == ref[4:]


def test_resume_restores_step_count_and_schedule(tmp_path):
    f = str(tmp_path / "ckpt.npz")
    sched = mx.lr_scheduler.FactorScheduler(step=3, factor=0.5, base_lr=0.1)
    step = _step_for(_net(1), "sgd", lr_scheduler=sched)
    for x, y in _batches(5, seed=1):
        step(x, y)
    assert step._num_update == 5
    save_train_step(step, f)

    sched2 = mx.lr_scheduler.FactorScheduler(step=3, factor=0.5, base_lr=0.1)
    step2 = _step_for(_net(2), "sgd", lr_scheduler=sched2)
    step2(*_batches(1)[0])
    load_train_step(step2, f)
    assert step2._num_update == 5
    assert step2.optimizer.num_update == 5
    assert int(step2._t) == 5
    # the next step's rate is the schedule's at count 6, not a cached one
    step2(*_batches(1)[0])
    assert float(step2._lr) == pytest.approx(sched2(6))


def test_load_writes_into_the_steps_own_tensors(tmp_path):
    """What a captured graph holds stays what the step holds: the load
    copies into every tensor (params, states, aux, the count) and
    rebinds none; the values are the snapshot's."""
    f = str(tmp_path / "ckpt.npz")
    batches = _batches(4, seed=3)
    step = _step_for(_net(3), "sgd", **SGD)
    for x, y in batches[:2]:
        step(x, y)
    save_train_step(step, f)
    saved = _host(step)
    for x, y in batches[2:]:
        step(x, y)
    held = [step._t, step._lr] + step._train + step._aux \
        + [s for st in step._states for s in st]
    ptrs = [t.data_ptr() for t in held]
    ids = [id(t) for t in held]
    load_train_step(step, f)
    now = [step._t, step._lr] + step._train + step._aux \
        + [s for st in step._states for s in st]
    assert [id(t) for t in now] == ids
    assert [t.data_ptr() for t in now] == ptrs
    for a, b in zip(saved, _host(step)):
        assert torch.equal(a, b)
    assert int(step._t) == 2 and step._num_update == 2


def test_mismatch_raises(tmp_path):
    f = str(tmp_path / "ckpt.npz")
    step = _step_for(_net(0))
    step(*_batches(1)[0])
    save_train_step(step, f)

    other = nn.HybridSequential()
    other.add(nn.Dense(3, in_units=8))
    other.initialize(ctx="cpu")
    s2 = _step_for(other)
    s2(np.random.randn(16, 8).astype(np.float32),
       np.random.randint(0, 3, (16,)))
    with pytest.raises(ValueError):
        load_train_step(s2, f)

    s3 = _step_for(_net(0), "sgd")
    s3(*_batches(1)[0])
    with pytest.raises(ValueError, match="optimizer mismatch"):
        load_train_step(s3, f)


def test_state_slot_and_dtype_mismatch_raise(tmp_path):
    """The port copies into the step's tensors, so every slot must have
    its counterpart and its dtype: SGD without momentum (no slot) into
    SGD with momentum (one), and a float32 file into a bfloat16 step,
    are user errors."""
    f = str(tmp_path / "ckpt.npz")
    s0 = _step_for(_net(1), "sgd", learning_rate=0.1, momentum=0.0)
    s0(*_batches(1)[0])
    save_train_step(s0, f)
    s1 = _step_for(_net(1), "sgd", learning_rate=0.1, momentum=0.9)
    s1(*_batches(1)[0])
    with pytest.raises(CheckpointMismatchError, match="state slots"):
        load_train_step(s1, f)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.BatchNorm(in_channels=16), nn.Dense(4, in_units=16))
    net.initialize(ctx="cpu")
    net.cast("bfloat16")
    s2 = _step_for(net, "sgd", learning_rate=0.1)
    x, y = _batches(1)[0]
    s2(torch.from_numpy(x).to(torch.bfloat16), y)
    before = _host(s2)
    with pytest.raises(CheckpointMismatchError, match="float32"):
        load_train_step(s2, f)
    for a, b in zip(before, _host(s2)):
        assert torch.equal(a, b)


def test_unbuilt_step_raises(tmp_path):
    step = _step_for(_net(0))
    with pytest.raises(ValueError):
        save_train_step(step, str(tmp_path / "x.npz"))
    with pytest.raises(ValueError):
        load_train_step(step, str(tmp_path / "x.npz"))


# ------------------------------------------ the sharded v2 format, one rank --
def test_sharded_v2_world_of_one_kill_and_resume(tmp_path):
    """The port's v2 directory in a world of one: one rank file and the
    manifest; a fresh step resumes the uninterrupted trajectory bit for
    bit (its tensors written in place)."""
    d = str(tmp_path / "v2")
    batches = _batches(8, seed=3)
    step = _step_for(_net(7))
    ref = [float(step(x, y)) for x, y in batches]
    s1 = _step_for(_net(7))
    for x, y in batches[:4]:
        s1(x, y)
    ck.save_train_step_sharded(s1, d, async_save=True).wait_until_finished()
    assert sorted(os.listdir(d)) == ["rank-0-of-1.npz"]
    man = json.load(open(d + ".manifest.json"))
    assert man["format"] == "port-v2" and man["num_update"] == 4
    assert man["layout"]["world"] == 1
    s2 = _step_for(_net(99))
    s2(*batches[0])
    held = [id(t) for t in s2._train]
    ck.load_train_step_sharded(s2, d)
    assert [id(t) for t in s2._train] == held
    assert [float(s2(x, y)) for x, y in batches[4:]] == ref[4:]


def test_sharded_v2_refuses_the_jax_packages_orbax_directory(tmp_path):
    """A v2 directory the JAX package wrote (an orbax tree) is refused
    with a ValueError before anything is read; a missing manifest is
    refused with the JAX package's text."""
    pytest.importorskip("orbax.checkpoint")
    d = str(tmp_path / "orbax")
    jmx.random.seed(1)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, activation="relu", in_units=8),
             jnn.BatchNorm(in_channels=16), jnn.Dense(4, in_units=16))
    jnet.initialize()
    jstep = jparallel.TrainStep(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
        jmx.optimizer.create("adam"),
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    x, y = _batches(1)[0]
    jstep(x, y)
    jck.save_train_step_sharded(jstep, d, async_save=False)
    step = _step_for(_net(1))
    step(x, y)
    before = _host(step)
    with pytest.raises(ValueError, match="orbax"):
        ck.load_train_step_sharded(step, d)
    for a, b in zip(before, _host(step)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="missing .*manifest"):
        ck.load_train_step_sharded(step, str(tmp_path / "nothing"))


# ------------------------------------------------------- fault tolerance --
def test_atomic_payload_crash_mid_write_keeps_previous(tmp_path):
    f = str(tmp_path / "ckpt.npz")
    batches = _batches(4, seed=9)
    step = _step_for(_net(3))
    for x, y in batches[:2]:
        step(x, y)
    save_train_step(step, f)
    good = os.path.getmtime(f)
    at_save = [t.detach().clone() for t in step._train]

    for x, y in batches[2:]:
        step(x, y)
    with fault.inject("checkpoint.replace", OSError("killed mid-write")):
        with pytest.raises(OSError):
            save_train_step(step, f)
    assert os.path.exists(f + ".tmp")        # orphan from the dead write
    assert os.path.getmtime(f) == good       # committed file untouched

    step2 = _step_for(_net(44))
    step2(*batches[0])
    load_train_step(step2, f)                # previous checkpoint loads
    for b, a in zip(at_save, step2._train):
        assert torch.equal(b, a)


def test_checkpoint_write_point_fires_before_io(tmp_path):
    f = str(tmp_path / "never.npz")
    step = _step_for(_net(3))
    step(*_batches(1)[0])
    with fault.inject("checkpoint.write", RuntimeError("preempted")):
        with pytest.raises(RuntimeError):
            save_train_step(step, f)
    assert not os.path.exists(f) and not os.path.exists(f + ".tmp")


def test_manager_every_n_and_retention(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=2, keep_last=2)
    for x, y in _batches(7, seed=2):
        step(x, y)
        mgr.maybe_save()
    assert [n for n, _ in mgr.checkpoints()] == [4, 6]
    assert mgr.maybe_save() is None          # step 7: not on cadence


def test_manager_cleans_orphan_tmp(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=2)
    step(*_batches(1)[0])
    mgr.save()
    orphan = os.path.join(d, mgr.prefix + "-junk.npz.tmp")
    with open(orphan, "wb") as f:
        f.write(b"dead write")
    step(*_batches(1, seed=4)[0])
    mgr.save()
    assert not os.path.exists(orphan)


def test_resume_latest_empty_dir_returns_none(tmp_path):
    step = _step_for(_net(3))
    step(*_batches(1)[0])
    assert resume_latest(step, str(tmp_path / "nope")) is None


def test_resume_latest_skips_unreadable_newest(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=3)
    batches = _batches(3, seed=6)
    for x, y in batches:
        step(x, y)
        mgr.maybe_save()
    newest = mgr.checkpoints()[-1][1]
    with open(newest, "wb") as f:
        f.write(b"PK\x03\x04 not really a zip")

    step2 = _step_for(_net(44))
    step2(*batches[0])
    assert resume_latest(step2, d) == 2      # fell back to the older one


def test_resume_latest_model_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    step(*_batches(1)[0])
    CheckpointManager(step, d, every_n_steps=1).save()

    other = nn.HybridSequential()
    other.add(nn.Dense(3, in_units=8))
    other.initialize(ctx="cpu")
    s2 = _step_for(other)
    s2(np.random.randn(16, 8).astype(np.float32),
       np.random.randint(0, 3, (16,)))
    with pytest.raises(ValueError):          # user error — never silent
        resume_latest(s2, d)


def _corrupt_payload_keep_marker(path):
    """A wrong-shaped p.0 with the v1.1 digests recomputed: a file that
    passes the integrity check and fails the model match."""
    z = dict(np.load(path))
    z["p.0"] = np.zeros((1, 1), np.float32)
    manifest = json.loads(bytes(z["__manifest__"]).decode())
    entries = {k: a for k, a in z.items() if k != "__manifest__"}
    manifest["digests"] = {
        k: zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF
        for k, a in entries.items()}
    manifest["sizes"] = {
        k: np.ascontiguousarray(a).nbytes for k, a in entries.items()}
    z["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(),
                                      dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **z)


def test_resume_latest_skips_validation_damage_when_older_loads(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=3)
    batches = _batches(3, seed=6)
    for x, y in batches:
        step(x, y)
        mgr.maybe_save()
    _corrupt_payload_keep_marker(mgr.checkpoints()[-1][1])

    step2 = _step_for(_net(44))
    step2(*batches[0])
    assert resume_latest(step2, d) == 2      # fell back past the damage


def test_resume_latest_systematic_mismatch_still_raises(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=3)
    for x, y in _batches(2, seed=6):
        step(x, y)
        mgr.maybe_save()
    for _, path in mgr.checkpoints():
        _corrupt_payload_keep_marker(path)

    step2 = _step_for(_net(44))
    step2(*_batches(1)[0])
    with pytest.raises(CheckpointMismatchError):
        resume_latest(step2, d)


def test_kill_and_resume_via_inject_bit_exact(tmp_path):
    d = str(tmp_path / "ckpts")
    batches = _batches(8, seed=1)

    ref_step = _step_for(_net(7))
    ref = [float(ref_step(x, y)) for x, y in batches]

    step1 = _step_for(_net(7))
    mgr = CheckpointManager(step1, d, every_n_steps=2, keep_last=2)
    with fault.inject("step", RuntimeError("preempted"), after_n=5) as h:
        with pytest.raises(RuntimeError, match="preempted"):
            for x, y in batches:
                step1(x, y)
                mgr.maybe_save()
    assert h.fired == 1
    del step1, mgr

    step2 = _step_for(_net(99))
    step2(*batches[0])
    n = resume_latest(step2, d)
    assert n == 4
    resumed = [float(step2(x, y)) for x, y in batches[n:]]
    assert resumed == ref[n:]


def _tear_members(path, select, keep):
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    for n in select(members):
        members[n] = members[n][:keep(members[n])]
    with zipfile.ZipFile(path, "w") as z:
        for n, blob in members.items():
            z.writestr(n, blob)


def test_resume_latest_skips_truncated_inner_array(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=3)
    batches = _batches(3, seed=8)
    for x, y in batches:
        step(x, y)
        mgr.maybe_save()
    _tear_members(mgr.checkpoints()[-1][1],
                  lambda m: [max(m, key=lambda n: len(m[n]))],
                  lambda blob: len(blob) // 2)

    step2 = _step_for(_net(44))
    step2(*batches[0])
    assert resume_latest(step2, d) == 2      # skipped 3, restored 2


def test_failed_load_leaves_step_untouched(tmp_path):
    """Good params, a torn aux section: the load is refused before any
    tensor is written."""
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=1)
    step(*_batches(1, seed=8)[0])
    mgr.save()
    _tear_members(mgr.checkpoints()[-1][1],
                  lambda m: [n for n in m if n.startswith("a.")],
                  lambda blob: 10)

    step2 = _step_for(_net(44))
    step2(*_batches(1, seed=8)[0])
    before = _host(step2)
    n_before = step2._num_update
    assert resume_latest(step2, d) is None       # nothing loadable
    for a, b in zip(before, _host(step2)):
        assert torch.equal(a, b)
    assert step2._num_update == n_before


# ------------------------------------------------------ corruption matrix --
@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """One built step and two committed v1.1 snapshots of it."""
    step = _step_for(_net(7))
    batches = _batches(3, seed=5)
    d = tmp_path_factory.mktemp("snaps")
    step(*batches[0])
    p1 = str(d / "ckpt-00000001.npz")
    save_train_step(step, p1)
    step(*batches[1])
    p2 = str(d / "ckpt-00000002.npz")
    save_train_step(step, p2)
    return {"step": step, "p1": p1, "p2": p2, "batches": batches}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _rewrite(path, members):
    with zipfile.ZipFile(path, "w") as z:
        for n, blob in members.items():
            z.writestr(n, blob)


def _npy_blob(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _truncate_zip(path):
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])


def _flip_array_bit(path):
    m = _members(path)
    big = max((n for n in m if n.startswith("p.")), key=lambda n: len(m[n]))
    blob = bytearray(m[big])
    blob[-1] ^= 1
    m[big] = bytes(blob)
    _rewrite(path, m)


def _truncate_manifest(path):
    m = _members(path)
    m[_MANIFEST_MEMBER] = m[_MANIFEST_MEMBER][:len(m[_MANIFEST_MEMBER]) // 2]
    _rewrite(path, m)


def _garbage_manifest(path):
    m = _members(path)
    m[_MANIFEST_MEMBER] = _npy_blob(
        np.frombuffer(b"}{ not json at all", dtype=np.uint8))
    _rewrite(path, m)


def _drop_param_entry(path):
    m = _members(path)
    big = max((n for n in m if n.startswith("p.")), key=lambda n: len(m[n]))
    del m[big]
    _rewrite(path, m)


CORRUPTORS = {
    "truncated-zip": _truncate_zip,
    "bitflipped-array": _flip_array_bit,
    "truncated-manifest": _truncate_manifest,
    "garbage-manifest": _garbage_manifest,
    "missing-param-entry": _drop_param_entry,
}


@pytest.mark.parametrize("kind", sorted(CORRUPTORS))
def test_corruption_matrix_detected_before_staging(kind, snap, tmp_path):
    """Every corruption shape raises CheckpointCorruptError from the
    deep verifier, the params-only reader and the step loader (which
    leaves the step as it was)."""
    path = str(tmp_path / "ckpt-00000002.npz")
    shutil.copy(snap["p2"], path)
    CORRUPTORS[kind](path)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(path)
    with pytest.raises(CheckpointCorruptError):
        load_snapshot_params(path)
    before = _host(snap["step"])
    with pytest.raises(CheckpointCorruptError):
        load_train_step(snap["step"], path)
    for a, b in zip(before, _host(snap["step"])):
        assert torch.equal(a, b)


def test_verify_checkpoint_ok_returns_v11_manifest(snap):
    manifest = verify_checkpoint(snap["p2"])
    assert manifest["format"] == FORMAT_VERSION
    with np.load(snap["p2"]) as z:
        entries = set(z.files) - {"__manifest__"}
    assert set(manifest["digests"]) == entries
    assert set(manifest["sizes"]) == entries
    assert all(int(n) > 0 for n in manifest["sizes"].values())


def test_verify_checkpoint_missing_file_is_stale_not_corrupt(tmp_path):
    with pytest.raises(FileNotFoundError):
        verify_checkpoint(str(tmp_path / "ckpt-00000404.npz"))


def test_verify_failures_gauge_counts_every_detection(snap, tmp_path):
    path = str(tmp_path / "ckpt-00000002.npz")
    shutil.copy(snap["p2"], path)
    _flip_array_bit(path)
    g = telemetry.registry().gauge("ckpt_verify_failures")
    before = g.value
    with pytest.raises(CheckpointCorruptError, match="crc32 mismatch"):
        verify_checkpoint(path)
    assert g.value == before + 1


def test_resume_latest_skips_bitflipped_to_older_intact(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(3))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=3)
    batches = _batches(3, seed=8)
    for x, y in batches:
        step(x, y)
        mgr.maybe_save()
    _flip_array_bit(mgr.checkpoints()[-1][1])

    step2 = _step_for(_net(44))
    step2(*batches[0])
    assert resume_latest(step2, d) == 2


def test_bitflip_injection_is_invisible_to_container_but_not_digest(
        snap, tmp_path):
    bad = str(tmp_path / "ckpt-00000002.npz")
    with fault.inject("checkpoint.serialize", BitFlipInjection(),
                      times=1) as h:
        save_train_step(snap["step"], bad)
    assert h.fired == 1
    with zipfile.ZipFile(bad) as z:
        assert z.testzip() is None
    with pytest.raises(CheckpointCorruptError, match="crc32 mismatch"):
        verify_checkpoint(bad)
    with pytest.raises(CheckpointCorruptError):
        load_snapshot_params(bad)


def test_ckpt_fault_points_registered():
    pts = fault.points()
    for name in ("checkpoint.serialize", "checkpoint.fsync",
                 "checkpoint.verify", "checkpoint.replace",
                 "checkpoint.write"):
        assert name in pts, name


def test_fsync_fault_aborts_before_commit(snap, tmp_path):
    f = str(tmp_path / "ckpt-00000042.npz")
    with fault.inject("checkpoint.fsync", RuntimeError("disk gone"),
                      times=1) as h:
        with pytest.raises(RuntimeError, match="disk gone"):
            save_train_step(snap["step"], f)
    assert h.fired == 1
    assert not os.path.exists(f)
    assert os.path.exists(f + ".tmp")


def test_verify_fault_point_fires_on_every_check(snap):
    with fault.inject("checkpoint.verify", RuntimeError("verify-probe"),
                      times=1) as h:
        with pytest.raises(RuntimeError, match="verify-probe"):
            verify_checkpoint(snap["p2"])
    assert h.fired == 1


def _strip_v11(path):
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
    for k in ("format", "digests", "sizes"):
        manifest.pop(k, None)
    m = _members(path)
    m[_MANIFEST_MEMBER] = _npy_blob(np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8))
    _rewrite(path, m)


def test_pre_v11_snapshot_still_loads(snap, tmp_path, caplog):
    path = str(tmp_path / "ckpt-00000002.npz")
    shutil.copy(snap["p2"], path)
    _strip_v11(path)
    with caplog.at_level(logging.INFO,
                         logger="mxnet_tpu_torch.parallel.checkpoint"):
        manifest = verify_checkpoint(path)
    assert "pre-v1.1" in caplog.text
    assert "digests" not in manifest

    params, names = load_snapshot_params(path)
    assert len(params) == len(names) > 0
    v11_params, _ = load_snapshot_params(snap["p2"])
    for got, want in zip(params, v11_params):
        np.testing.assert_array_equal(got, want)

    step2 = _step_for(_net(11))
    step2(*snap["batches"][0])
    load_train_step(step2, path)
    assert step2._num_update == 2


def test_pre_v11_truncated_entry_still_detected(snap, tmp_path):
    path = str(tmp_path / "ckpt-00000002.npz")
    shutil.copy(snap["p2"], path)
    _strip_v11(path)
    m = _members(path)
    big = max((n for n in m if n.startswith("p.")), key=lambda n: len(m[n]))
    m[big] = m[big][:len(m[big]) // 2]
    _rewrite(path, m)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(path)


# -------------------------------------------------------- async pipeline --
def test_async_snapshotter_roundtrip(snap, tmp_path):
    f = str(tmp_path / "ckpt-00000002.npz")
    s = AsyncSnapshotter()
    try:
        assert s.save(snap["step"], f) is True
        assert s.wait_until_finished(timeout=60)
        assert s.snapshots_written == 1
        assert s.errors == []
        assert verify_checkpoint(f)["format"] == FORMAT_VERSION
        sync_params, _ = load_snapshot_params(snap["p2"])
        async_params, _ = load_snapshot_params(f)
        for a, b in zip(sync_params, async_params):
            np.testing.assert_array_equal(a, b)
    finally:
        s.close(timeout=30)
    with pytest.raises(RuntimeError, match="closed"):
        s.save(snap["step"], f)


def test_async_snapshot_is_the_state_at_save_time(tmp_path):
    """The step updates its tensors in place: a write still queued when
    later steps run must hold the state at its save, not a later one."""
    real = ck._write_payload
    gate = threading.Event()

    def slow(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)

    step = _step_for(_net(5), "sgd", **SGD)
    batches = _batches(4, seed=5)
    step(*batches[0])
    f = str(tmp_path / "ckpt-00000001.npz")
    at_save = [t.numpy().copy() for t in _host(step)]
    s = AsyncSnapshotter()
    ck._write_payload = slow
    try:
        assert s.save(step, f)
        for x, y in batches[1:]:
            step(x, y)
        gate.set()
        assert s.wait_until_finished(timeout=60)
    finally:
        ck._write_payload = real
        gate.set()
        s.close(timeout=30)
    with np.load(f) as z:
        got = [z[k] for k in z.files if k != "__manifest__"]
    for a, b in zip(at_save, got):
        np.testing.assert_array_equal(a, b)


def test_async_skip_if_busy_bounds_the_queue(snap, tmp_path, monkeypatch):
    real = ck._write_payload
    gate = threading.Event()

    def slow(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)

    monkeypatch.setattr(ck, "_write_payload", slow)
    f1 = str(tmp_path / "ckpt-00000001.npz")
    f2 = str(tmp_path / "ckpt-00000002.npz")
    s = AsyncSnapshotter(max_pending=1)
    try:
        assert s.save(snap["step"], f1) is True
        assert s.save(snap["step"], f2) is False          # skip-if-busy
        assert s.snapshots_skipped == 1
        assert s.pending_writes == 1
        assert s.wait_until_finished(timeout=0.2) is False
        gate.set()
        assert flush_pending(timeout=60)
        assert s.pending_writes == 0
        assert s.snapshots_written == 1
    finally:
        gate.set()
        s.close(timeout=30)
    verify_checkpoint(f1)
    assert not os.path.exists(f2)
    assert telemetry.ckpt_gauges()["ckpt_snapshots_skipped"] >= 1


def test_async_writer_failure_is_latched_not_fatal(snap, tmp_path,
                                                   monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("disk full")

    monkeypatch.setattr(ck, "_write_payload", boom)
    f = str(tmp_path / "ckpt-00000009.npz")
    s = AsyncSnapshotter()
    try:
        assert s.save(snap["step"], f) is True
        assert s.wait_until_finished(timeout=30)
    finally:
        s.close(timeout=30)
    assert s.snapshots_written == 0
    assert len(s.errors) == 1
    bad_fname, exc = s.errors[0]
    assert bad_fname == f and "disk full" in str(exc)
    assert not os.path.exists(f)


def test_flush_pending_with_no_live_snapshotters():
    assert flush_pending(timeout=1.0) is True


def test_manager_async_save_commits_and_retains(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(23))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=2,
                            async_save=True, max_pending=8)
    try:
        for x, y in _batches(4, seed=9):
            step(x, y)
            assert mgr.maybe_save() is not None
        assert mgr.wait_until_finished(timeout=60)
        assert mgr.snapshots_skipped == 0
        assert mgr.write_errors == []
        cks = mgr.checkpoints()
        assert len(cks) == 2
        assert cks[-1][0] == step._num_update
        for _, p in cks:
            verify_checkpoint(p)
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    finally:
        mgr.close(timeout=30)

    step2 = _step_for(_net(31))
    step2(*_batches(1, seed=9)[0])
    assert resume_latest(step2, d) == 4


def test_ckpt_gauges_family(snap, tmp_path):
    g = telemetry.ckpt_gauges()
    assert set(g) == set(GAUGES)
    save_train_step(snap["step"], str(tmp_path / "ckpt-00000003.npz"))
    g = telemetry.ckpt_gauges()
    assert g["ckpt_bytes"] > 0
    assert g["ckpt_last_snapshot_ms"] >= 0
    assert g["ckpt_pending_writes"] == 0


class _FakeStep:
    """A built step with one large host tensor, so serialize and fsync
    dominate a synchronous write."""

    _built = True

    def __init__(self, mb=16):
        n = (mb * 1024 * 1024) // 4
        rng = np.random.RandomState(0)
        self._train = [torch.from_numpy(rng.rand(n).astype(np.float32))]
        self._states = [()]
        self._aux = []
        self._names = ["w"]
        self._train_idx = [0]
        self._aux_idx = []
        self.optimizer = mx.optimizer.create("sgd")
        self._num_update = 1


def test_async_stall_bound(tmp_path):
    """The step loop's stall of an async save (copying into the
    staging buffer) stays within 25% of a synchronous write of the same
    payload."""
    step = _FakeStep()
    sync_s, stall_s = [], []
    s = AsyncSnapshotter(max_pending=1)
    try:
        for i in range(3):
            t0 = time.perf_counter()
            save_train_step(step, str(tmp_path / f"sync-{i:04d}.npz"))
            sync_s.append(time.perf_counter() - t0)

            f = str(tmp_path / f"async-{i:04d}.npz")
            t0 = time.perf_counter()
            assert s.save(step, f) is True
            stall_s.append(time.perf_counter() - t0)
            assert s.wait_until_finished(timeout=120)
            verify_checkpoint(f)
    finally:
        s.close(timeout=60)
    assert min(stall_s) <= 0.25 * max(sync_s), (sync_s, stall_s)


def test_retention_keeps_newest_sync(tmp_path):
    d = str(tmp_path / "ckpts")
    step = _step_for(_net(13))
    mgr = CheckpointManager(step, d, every_n_steps=1, keep_last=1)
    for x, y in _batches(3, seed=13):
        step(x, y)
        mgr.maybe_save()
    cks = mgr.checkpoints()
    assert len(cks) == 1
    assert cks[0][0] == step._num_update
    verify_checkpoint(cks[0][1])


def test_manager_latest_step_and_listing(tmp_path):
    assert ck.latest_step(tmp_path) is None
    for n in (4, 8):
        (tmp_path / f"ckpt-{n:08d}.npz").touch()
    assert ck.latest_step(tmp_path) == 8
    assert CheckpointManager(object(), tmp_path).latest_step() == 8
    assert list_checkpoints(tmp_path) == jck.list_checkpoints(tmp_path)
    assert ck.wait_for_new(tmp_path, last_seen=8, timeout=0.05) is None
    assert ck.wait_for_new(tmp_path, last_seen=4)[0] == 8


# ------------------------------------------- cross-load with the JAX side --
def _jax_net(seed, dtype=None, bn=True):
    jmx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, activation="relu", in_units=8))
    if bn:
        net.add(jnn.BatchNorm(in_channels=16))
    net.add(jnn.Dense(4, in_units=16))
    net.initialize()
    if dtype:
        net.cast(dtype)
    return net


def _port_net_like(jnet, dtype=None, bn=True):
    """The port's net of the same layers with the JAX net's values."""
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8))
    if bn:
        net.add(nn.BatchNorm(in_channels=16))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(ctx="cpu")
    if dtype:
        net.cast(dtype)
    for jp, tp in zip(jnet.collect_params().values(),
                      net.collect_params().values()):
        a = np.asarray(jp.data()._data)
        if a.dtype == ml_dtypes.bfloat16:
            tp.set_data(torch.from_numpy(a.view(np.int16).copy())
                        .view(torch.bfloat16))
        else:
            tp.set_data(a)
    return net


def _jstep(net, **kw):
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    return jparallel.TrainStep(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                               jmx.optimizer.create("sgd", **kw), mesh=mesh)


def _loss(v):
    return float(v.asnumpy()) if hasattr(v, "asnumpy") else float(v)


def _jax_values(jstep, jnet):
    jstep.sync_params_to_net()
    return [np.asarray(p.data()._data) for p in
            jnet.collect_params().values()]


def _port_values(tstep, tnet):
    tstep.sync_params_to_net()
    return [p.tensor().detach().numpy() for p in
            tnet.collect_params().values()]


PACKAGES = {"jax": (jck.save_train_step, jck.load_train_step,
                    jck.verify_checkpoint),
            "port": (save_train_step, load_train_step, verify_checkpoint)}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_cross_load_f32_continues_to_the_same_losses(writer, reader,
                                                     tmp_path):
    """A float32 snapshot from one package verifies and loads in the
    other; both steps then take 3 more steps to the same losses and
    weights."""
    batches = _batches(6, seed=11)
    jnet = _jax_net(5)
    tnet = _port_net_like(jnet)
    steps = {"jax": _jstep(jnet, **SGD), "port": _step_for(tnet, "sgd",
                                                           **SGD)}
    src, dst = steps[writer], steps[reader]
    f = str(tmp_path / "ckpt-00000003.npz")
    for x, y in batches[:3]:
        src(x, y)
    PACKAGES[writer][0](src, f)
    manifest = PACKAGES[reader][2](f)
    assert manifest["format"] == "1.1" and manifest["num_update"] == 3
    dst(*batches[0])                     # build
    PACKAGES[reader][1](dst, f)
    assert dst._num_update == 3
    lw = [_loss(src(x, y)) for x, y in batches[3:]]
    lr = [_loss(dst(x, y)) for x, y in batches[3:]]
    np.testing.assert_allclose(lr, lw, **CROSS)
    for a, b in zip(_jax_values(steps["jax"], jnet),
                    _port_values(steps["port"], tnet)):
        np.testing.assert_allclose(b, a, **CROSS)


def _by_param(manifest):
    """Per parameter and running statistic, in the order the loaders
    pair them (natural order of the names: each process numbers its
    blocks from its own counters, so the entry index of a parameter may
    differ between two files), its counter-free name and the (digest,
    size) of its entries."""
    out = []
    for kind, names in (("p", manifest["train_names"]),
                        ("a", manifest["aux_names"])):
        for k in ck._natural_order(names):
            keys = [f"{kind}.{k}"]
            if kind == "p":
                keys += [f"s.{k}.{j}"
                         for j in range(manifest["state_counts"][k])]
            out.append((ck._norm_name(names[k]),
                        [(manifest["digests"][x], manifest["sizes"][x])
                         for x in keys]))
    return out


ROUND_TRIPS = {"jax-port-f32": ("jax", "port", None),
               "port-jax-f32": ("port", "jax", None),
               "jax-port-bf16": ("jax", "port", "bfloat16")}


@pytest.mark.parametrize("trip", sorted(ROUND_TRIPS))
def test_round_trip_keeps_entries_and_digests(trip, tmp_path):
    """A snapshot loaded by the other package and written again by it
    has the same entries, sizes, digests, names and count: the same
    bytes (a bfloat16 entry as its two raw bytes in both)."""
    writer, reader, dtype = ROUND_TRIPS[trip]
    kw = dict(SGD, multi_precision=True) if dtype else SGD
    batches = _batches(2, seed=12)
    jnet = _jax_net(6, dtype=dtype, bn=dtype is None)
    tnet = _port_net_like(jnet, dtype=dtype, bn=dtype is None)
    steps = {"jax": _jstep(jnet, **kw),
             "port": _step_for(tnet, "sgd", **kw)}

    def feed(pkg, x, y):
        if dtype and pkg == "jax":
            return steps[pkg](x.astype(ml_dtypes.bfloat16), y)
        if dtype:
            return steps[pkg](torch.from_numpy(x).to(torch.bfloat16), y)
        return steps[pkg](x, y)

    f1, f2 = str(tmp_path / "first.npz"), str(tmp_path / "second.npz")
    feed(writer, *batches[0])
    feed(writer, *batches[1])
    PACKAGES[writer][0](steps[writer], f1)
    feed(reader, *batches[0])
    PACKAGES[reader][1](steps[reader], f1)
    PACKAGES[reader][0](steps[reader], f2)
    m1, m2 = jck.verify_checkpoint(f1), verify_checkpoint(f2)
    for k in ("optimizer", "num_update", "format"):
        assert m1[k] == m2[k], k
    assert set(m1["digests"]) == set(m2["digests"])
    assert _by_param(m1) == _by_param(m2)
    if dtype:
        with np.load(f1) as z:
            assert z["p.0"].dtype == np.dtype("V2")     # raw bf16 bytes
            assert z["s.0.1"].dtype == np.float32       # the f32 master


def test_jax_bfloat16_snapshot_loads_in_the_port_bit_for_bit(tmp_path):
    batches = _batches(2, seed=13)
    kw = dict(SGD, multi_precision=True)
    jnet = _jax_net(8, dtype="bfloat16", bn=False)
    jstep = _jstep(jnet, **kw)
    for x, y in batches:
        jstep(x.astype(ml_dtypes.bfloat16), y)
    f = str(tmp_path / "ckpt-00000002.npz")
    jck.save_train_step(jstep, f)
    verify_checkpoint(f)

    tnet = _port_net_like(_jax_net(9, dtype="bfloat16", bn=False),
                          dtype="bfloat16", bn=False)
    tstep = _step_for(tnet, "sgd", **kw)
    xb = torch.from_numpy(batches[0][0]).to(torch.bfloat16)
    tstep(xb, batches[0][1])
    load_train_step(tstep, f)
    with np.load(f) as z:
        for name, t in ck._entries(tstep):
            assert t.dtype == (torch.bfloat16 if name.startswith("p.")
                               else torch.float32)
            raw = t.detach().contiguous().view(torch.uint8).numpy()
            assert raw.tobytes() == z[name].tobytes(), name
    assert tstep._num_update == 2
    assert np.isfinite(float(tstep(xb, batches[0][1])))


def test_jax_package_cannot_load_bfloat16_train_step_snapshot(tmp_path):
    """The reference's own defect (ROADMAP C7): ``np.load`` gives its
    bfloat16 entries as ``V2`` and its ``load_train_step`` hands them to
    JAX, which refuses the dtype.  The port must not copy it (the test
    above loads the same file)."""
    batches = _batches(1, seed=14)
    kw = dict(SGD, multi_precision=True)
    jstep = _jstep(_jax_net(10, dtype="bfloat16", bn=False), **kw)
    x, y = batches[0]
    jstep(x.astype(ml_dtypes.bfloat16), y)
    f = str(tmp_path / "ckpt-00000001.npz")
    jck.save_train_step(jstep, f)
    with np.load(f) as z:
        assert z["p.0"].dtype == np.dtype("V2")
    jstep2 = _jstep(_jax_net(10, dtype="bfloat16", bn=False), **kw)
    jstep2(x.astype(ml_dtypes.bfloat16), y)
    with pytest.raises(TypeError, match="V2"):
        jck.load_train_step(jstep2, f)


# ----------------------------------- damage verdicts against the JAX side --
CKPT = {"jax": jck, "port": ck}
FAULT = {"jax": jfault, "port": fault}


def _verdict(fn, *args):
    """``(outcome, result)``: ``"ok"`` or the class name of what ``fn``
    raised — the two packages' exception classes differ by module only."""
    try:
        return "ok", fn(*args)
    except Exception as exc:
        return type(exc).__name__, None


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The same float32 net and SGD under each package's built
    ``TrainStep``, three snapshots (num_update 1..3) committed by each
    package's own ``CheckpointManager``, and a step of another model in
    each package."""
    jnet = _jax_net(21)
    tnet = _port_net_like(jnet)
    steps = {"jax": _jstep(jnet, **SGD), "port": _step_for(tnet, "sgd",
                                                           **SGD)}
    dirs = {}
    for pkg, step in steps.items():
        dirs[pkg] = str(tmp_path_factory.mktemp(f"twins-{pkg}"))
        mgr = CKPT[pkg].CheckpointManager(step, dirs[pkg], every_n_steps=1,
                                          keep_last=3)
        for x, y in _batches(3, seed=21):
            step(x, y)
            mgr.maybe_save()
        assert [n for n, _ in mgr.checkpoints()] == [1, 2, 3]
    other_j = jnn.HybridSequential()
    other_j.add(jnn.Dense(3, in_units=8))
    other_j.initialize()
    other_t = nn.HybridSequential()
    other_t.add(nn.Dense(3, in_units=8))
    other_t.initialize(ctx="cpu")
    others = {"jax": _jstep(other_j, **SGD),
              "port": _step_for(other_t, "sgd", **SGD)}
    x = np.random.RandomState(22).randn(16, 8).astype(np.float32)
    y = np.arange(16, dtype=np.int32) % 3
    for s in others.values():
        s(x, y)
    return {"steps": steps, "nets": {"jax": jnet, "port": tnet},
            "dirs": dirs, "others": others}


def _tear_aux(path):
    _tear_members(path, lambda m: [n for n in m if n.startswith("a.")],
                  lambda blob: 10)


def _tear_largest(path):
    _tear_members(path, lambda m: [max(m, key=lambda n: len(m[n]))],
                  lambda blob: len(blob) // 2)


def _not_a_zip(path):
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 not really a zip")


def _pre_v11_truncated(path):
    _strip_v11(path)
    m = _members(path)
    big = max((n for n in m if n.startswith("p.")), key=lambda n: len(m[n]))
    m[big] = m[big][:len(m[big]) // 2]
    _rewrite(path, m)


FILE_DAMAGE = dict(CORRUPTORS, **{
    "intact": lambda path: None,
    "pre-v11": _strip_v11,
    "pre-v11-truncated-entry": _pre_v11_truncated,
    "wrong-shape-digests-recomputed": _corrupt_payload_keep_marker,
    "torn-aux": _tear_aux,
    "truncated-inner-array": _tear_largest,
    "not-a-zip": _not_a_zip,
    "bitflip-injection": None,           # flipped by the writer itself
})


@pytest.mark.parametrize("writer", sorted(CKPT))
@pytest.mark.parametrize("kind", sorted(FILE_DAMAGE))
def test_damage_verdicts_match_the_reference(kind, writer, twins,
                                             tmp_path):
    """One snapshot, damaged once; ``verify_checkpoint``,
    ``load_snapshot_params`` and ``load_train_step`` of both packages
    read that same file and reach the same verdict: the same exception
    class, or the same manifest, parameters and restored state."""
    path = str(tmp_path / "ckpt-00000003.npz")
    if kind == "bitflip-injection":
        with FAULT[writer].inject("checkpoint.serialize",
                                  CKPT[writer].BitFlipInjection(),
                                  times=1) as h:
            CKPT[writer].save_train_step(twins["steps"][writer], path)
        assert h.fired == 1
    else:
        shutil.copy(os.path.join(twins["dirs"][writer],
                                 "ckpt-00000003.npz"), path)
        FILE_DAMAGE[kind](path)
    verdicts, loaded = {}, {}
    for pkg, mod in CKPT.items():
        step = twins["steps"][pkg]
        v_out, manifest = _verdict(mod.verify_checkpoint, path)
        p_out, params = _verdict(mod.load_snapshot_params, path)
        before = (_host(step) if pkg == "port"
                  else [np.asarray(a) for a in step._train_arrays])
        l_out, _ = _verdict(mod.load_train_step, step, path)
        verdicts[pkg] = (v_out, manifest, p_out,
                         params and ([a.tobytes() for a in params[0]],
                                     params[1]), l_out)
        if l_out == "ok":
            loaded[pkg] = (_port_values if pkg == "port" else _jax_values)(
                step, twins["nets"][pkg])
        elif pkg == "port":                   # a refused load writes nothing
            for a, b in zip(before, _host(step)):
                assert torch.equal(a, b)
    assert verdicts["port"] == verdicts["jax"], (verdicts["port"][::2],
                                                 verdicts["jax"][::2])
    if kind in ("intact", "pre-v11"):
        assert verdicts["port"][::2] == ("ok", "ok", "ok")
    else:
        assert verdicts["port"][-1] != "ok"
    for a, b in zip(loaded.get("jax", ()), loaded.get("port", ())):
        assert a.tobytes() == b.tobytes()


def _newest(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npz"))[-1]


def _each(d, damage):
    for f in os.listdir(d):
        damage(os.path.join(d, f))


def _orphan_tmp(d):
    with open(os.path.join(d, "ckpt-00000004.npz.tmp"), "wb") as f:
        f.write(b"dead write")


DIR_DAMAGE = {
    "intact": lambda d: None,
    "empty": lambda d: _each(d, os.remove),
    "orphan-tmp-of-a-dead-write": _orphan_tmp,
    "not-a-zip-newest": lambda d: _not_a_zip(os.path.join(d, _newest(d))),
    "bitflipped-newest": lambda d: _flip_array_bit(
        os.path.join(d, _newest(d))),
    "truncated-inner-array-newest": lambda d: _tear_largest(
        os.path.join(d, _newest(d))),
    "validation-damage-newest": lambda d: _corrupt_payload_keep_marker(
        os.path.join(d, _newest(d))),
    "systematic-mismatch": lambda d: _each(d, _corrupt_payload_keep_marker),
    "torn-aux-everywhere": lambda d: _each(d, _tear_aux),
    "another-model": None,               # intact files, the wrong step
}


@pytest.mark.parametrize("writer", sorted(CKPT))
@pytest.mark.parametrize("case", sorted(DIR_DAMAGE))
def test_resume_latest_verdicts_match_the_reference(case, writer, twins,
                                                    tmp_path):
    """The same damaged directory under both packages' ``resume_latest``:
    the same step restored (or none), or the same exception class — the
    split between file damage (skipped) and a model mismatch (raised)
    is the reference's."""
    d = str(tmp_path / "ckpts")
    shutil.copytree(twins["dirs"][writer], d)
    steps = twins["steps"]
    if case == "another-model":
        steps = twins["others"]
    else:
        DIR_DAMAGE[case](d)
    verdicts, loaded = {}, {}
    for pkg, mod in CKPT.items():
        verdicts[pkg] = _verdict(mod.resume_latest, steps[pkg], d)
        if verdicts[pkg][0] == "ok" and verdicts[pkg][1] is not None:
            loaded[pkg] = (_port_values if pkg == "port" else _jax_values)(
                steps[pkg], twins["nets"][pkg])
    assert verdicts["port"] == verdicts["jax"]
    expect = {"intact": ("ok", 3), "empty": ("ok", None),
              "orphan-tmp-of-a-dead-write": ("ok", 3),
              "systematic-mismatch": ("CheckpointMismatchError", None),
              "torn-aux-everywhere": ("ok", None),
              "another-model": ("CheckpointMismatchError", None)}
    assert verdicts["port"] == expect.get(case, ("ok", 2))
    for a, b in zip(loaded.get("jax", ()), loaded.get("port", ())):
        assert a.tobytes() == b.tobytes()
    if verdicts["port"][1] is not None:
        assert set(loaded) == {"jax", "port"}
