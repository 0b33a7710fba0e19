"""Checkpoint / resume for the port's ``TrainStep`` (the port of
``mxnet_tpu/parallel/checkpoint.py``'s v1 / v1.1 format).

A snapshot is ONE ``.npz`` per step count, the container ``nd.save``
uses, byte-compatible with the JAX package's: ``p.<i>`` is trainable
parameter i (in ``step._train_idx`` order), ``s.<i>.<j>`` its j-th
optimizer state tensor (the momentum, the Adam moments, the f32 master
weight of a half-precision parameter last), ``a.<i>`` running statistic
i, and ``__manifest__`` a JSON record of the names, the optimizer class,
the state counts and the step count.  v1.1 adds a format version and,
per entry, the crc32 digest and byte size of its raw bytes, computed
before the bytes reach the container: ``verify_checkpoint`` deep-checks
a file without a step, and every load verifies the digests before it
stages anything, so a flipped bit is *damage* (``resume_latest`` skips
it) and never loaded.  bfloat16 tensors are written as their two raw
bytes (numpy's ``V2``, what ``np.savez`` writes for the JAX package's
bfloat16 arrays), so the digests of equal weights are equal in both
packages, and either package's snapshot loads in the other.

Durability: the payload lands in ``<name>.tmp``, is fsynced, committed
with ``os.replace`` and the directory entry fsynced, so a committed
snapshot survives power loss and a crash at any point leaves the
previous one.

**In place.**  On the card the step is a captured CUDA graph that holds
the addresses of the step's tensors (parameters, optimizer state,
running statistics, the step count ``_t``).  ``load_train_step`` stages
and validates the whole file on the host first — a refused load leaves
the step untouched — and then copies into those same tensors; it never
rebinds one, so the next replay continues from the loaded state.  A
step is built (one step run) before a restore, as in the JAX package.

**Off the card.**  A snapshot's device-to-host copies run on a copy
stream that waits on an event recorded on the current stream (where the
step's graph replays), into one pinned buffer from ``storage``'s pinned
pool; the current stream then waits on the copies' event, so a later
replay cannot update a tensor under a copy in flight.  The host does not
wait: ``AsyncSnapshotter`` / ``CheckpointManager(async_save=True)`` hand
the buffer to a writer thread, which waits on that event (not on the
device), then serializes, fsyncs and commits.  Its queue is bounded
(``max_pending``) with skip-if-busy, which also bounds the pinned
buffers (one per write in flight, reused from save to save);
``flush_pending()`` drains every live snapshotter (the SIGTERM and
non-finite-abort exits call it).  A failed copy or write raises, or
latches in ``errors``: there is no synchronous fallback.

**A sharded step** (``TrainStep(mesh=, rules=)``, each rank holding
blocks of some leaves): every rank calls ``save_train_step``; each
sharded leaf and its optimizer state is gathered whole over the mesh
(the part the step blocks on, a collective every rank runs in the same
order), rank 0 writes the same v1.1 bytes a world of one would write,
and every rank then passes a barrier.  ``load_train_step`` reads and
verifies the file on every rank and copies only the rank's own block
of each leaf into the step's tensors, so one file loads into any
layout: a world of one, tp, fsdp, or another mesh than the one that
wrote it.  ``AsyncSnapshotter`` and ``CheckpointManager`` gather on
the step's thread and write on rank 0's writer thread.

**The sharded v2 format** (``save_train_step_sharded`` /
``load_train_step_sharded``) is the port's own, not the JAX package's
orbax tree: ``<directory>/rank-<r>-of-<n>.npz`` holds rank ``r``'s
blocks only (no gather), as the v1.1 entries ``p.*``/``s.*``/``a.*``
under the v1.1 integrity section and the same atomic commit, and
``<directory>.manifest.json`` (rank 0, temp-then-rename) holds the JAX
manifest's keys (``train_names``, ``aux_names``, ``optimizer``,
``shapes``, ``aux_shapes``, ``state_counts``), ``num_update``,
``format`` (``"port-v2"``), the save's random ``save_id`` and a
``layout`` section: the mesh's axis sizes, the world, and for each
entry its ``PartitionSpec`` and the blocks written, as ``[rank,
[[start, size], ...]]``.  Each block is written once: by the rank whose
coordinate is 0 on every mesh axis the entry is not split over (a
replicated entry by rank 0 alone), as orbax writes one replica.

The directory commits as a whole: rank 0 removes the old manifest
first, every rank commits its file (whose own manifest carries the
``save_id``, ``num_update`` and world), and rank 0 writes the new
manifest only after every rank's file has committed — in
``ShardedSave.wait_until_finished``, which every rank calls (the
synchronous save calls it).  A load checks every rank file it reads
against the manifest and raises ``CheckpointCorruptError`` on a file of
another save, so a crash in the middle of a re-save into the same
directory fails loudly, as the JAX package's does, and never mixes two
steps.  A load pairs saved and model names in natural order, validates
as the JAX package does (the same ``ValueError`` texts), and each rank
reads only the saved blocks that overlap the blocks it now holds, so a
directory written under one layout loads into any other.  A directory
the JAX package wrote (orbax) is refused with a ``ValueError`` before
anything is read.
"""
from __future__ import annotations

import json
import logging
import os
import queue as _queue
import re
import threading
import time as _time
import weakref
import zlib

import numpy as np
import torch

from .. import distributed as _dist
from .. import elastic as _elastic
from .. import storage as _storage
from .. import telemetry as _telemetry
from ..fault import fire as _fire

__all__ = ["save_train_step", "load_train_step",
           "save_train_step_sharded", "load_train_step_sharded",
           "ShardedSave",
           "CheckpointManager", "CheckpointMismatchError",
           "CheckpointCorruptError", "BitFlipInjection",
           "verify_checkpoint", "AsyncSnapshotter", "flush_pending",
           "resume_latest", "list_checkpoints", "latest_checkpoint",
           "latest_step", "wait_for_new", "load_snapshot_params"]

_MANIFEST = "__manifest__"
FORMAT_VERSION = "1.1"
_ALIGN = 64                     # byte alignment of entries in a staging buffer
_logger = logging.getLogger(__name__)


class CheckpointMismatchError(ValueError):
    """A checkpoint that READ fine does not MATCH the model (param
    name/shape/dtype, aux, state count or optimizer disagreement).
    Distinct from unreadable (truncated/corrupt) files so recovery paths
    like ``resume_latest`` can skip damage but refuse to paper over a
    user error."""


class CheckpointCorruptError(ValueError):
    """A snapshot whose BYTES are wrong: missing/truncated payload entry,
    byte-size drift, or a crc32 digest mismatch against the v1.1
    manifest.  Always *damage* (never user error): ``resume_latest``
    skips it for an older intact sibling."""


class BitFlipInjection(Exception):
    """Fault-armed corruption injector.  Armed on the
    ``checkpoint.serialize`` point via ``fault.inject``, the writer
    CATCHES it (instead of propagating) and flips one bit in one payload
    entry AFTER the manifest digests were computed — the committed
    snapshot is then silently corrupt at the container level (the zip
    CRCs are consistent with the flipped bytes), exactly the damage only
    the v1.1 digest check can catch::

        with fault.inject("checkpoint.serialize",
                          checkpoint.BitFlipInjection(), times=1):
            mgr.save()                    # commits a poisoned snapshot

    ``key`` picks the payload entry (default: the largest ``p.*``),
    ``byte`` the offset (default: the middle), ``bit`` the bit (0-7)."""

    def __init__(self, key=None, byte=None, bit=0):
        super().__init__(f"bit-flip injection (key={key}, byte={byte}, "
                         f"bit={bit})")
        self.key = key
        self.byte = byte
        self.bit = int(bit) & 7


def _norm_name(n):
    """Strip gluon's process-global instance counters: dense3_weight →
    dense_weight (structure is checked by sequence position + shape)."""
    return re.sub(r"(\D)\d+", r"\1", n)


def _natural_order(names):
    """Indices ordering ``names`` with numeric counters compared as numbers
    (dense9 < dense10).  The save/load pairing runs in this order on both
    sides: the plain lexicographic order param_names_and_values uses is NOT
    stable across processes (counters are process-global, and 'dense10' <
    'dense9' lexicographically), so positional restore needs it."""
    def key(i):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", names[i])]

    return sorted(range(len(names)), key=key)


# --------------------------------------------------------------- staging --
def _np_dtype(dtype):
    """The numpy dtype a tensor of ``dtype`` is written as: bfloat16 as
    its two raw bytes (``V2``)."""
    if dtype == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty((), dtype=dtype).numpy().dtype


def _placed_entries(step):
    """``(entry name, tensor, placement)`` in the file's order: ``p.*``,
    ``s.*``, ``a.*``.  A tensor is this rank's block under its
    ``placement`` (an optimizer state lies as its parameter does), or
    whole where the placement is None."""
    out = [(f"p.{k}", t, getattr(t, "_placement", None))
           for k, t in enumerate(step._train)]
    for k, states in enumerate(step._states):
        where = getattr(step._train[k], "_placement", None)
        out += [(f"s.{k}.{j}", s, where) for j, s in enumerate(states)]
    out += [(f"a.{k}", t, getattr(t, "_placement", None))
            for k, t in enumerate(step._aux)]
    return out


def _entries(step):
    """``(entry name, whole tensor)`` in the file's order; a sharded
    leaf is gathered over the mesh (a collective: every rank of the
    mesh calls this, in the same order)."""
    with torch.no_grad():
        return [(n, t if p is None else p.gather(t.detach()))
                for n, t, p in _placed_entries(step)]


def _whole_shape(t, placement=None):
    """The shape of the whole value of a step tensor."""
    placement = placement if placement is not None \
        else getattr(t, "_placement", None)
    return tuple(t.shape) if placement is None else placement.shape


def _sharded(step):
    return any(p is not None for _, _, p in _placed_entries(step))


_copy_streams = {}
_copy_streams_lock = threading.Lock()


def _copy_stream(device):
    """The process's stream for snapshot copies off ``device``."""
    with _copy_streams_lock:
        s = _copy_streams.get(device)
        if s is None:
            s = _copy_streams[device] = torch.cuda.Stream(device)
        return s


class _Staging:
    """One snapshot's host buffer: every entry's bytes at a
    ``_ALIGN``-aligned offset, pinned (from ``storage``'s pinned pool)
    when the step lies on the card.  ``views`` are the entries as
    tensors (the copies' targets), ``arrays`` the same bytes as numpy
    arrays (what the writer serializes); both are complete once
    ``wait()`` returns."""

    def __init__(self, entries):
        self.key = self._key(entries)
        offsets, total = [], 0
        for _, t in entries:
            offsets.append(total)
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self.nbytes = total
        self.device = entries[0][1].device if entries \
            else torch.device("cpu")
        self._handle = None
        if self.device.type == "cuda":
            self._handle = _storage.Storage.get().alloc(
                max(total, 1), ctx="cpu_pinned")
            buf = self._handle._pinned[:total]
        else:
            buf = torch.empty(total, dtype=torch.uint8)
        raw = buf.numpy()
        self.views, self.arrays = [], []
        for (_, t), off in zip(entries, offsets):
            n = t.numel() * t.element_size()
            self.views.append(buf[off:off + n].view(t.dtype)
                              .reshape(t.shape))
            self.arrays.append(raw[off:off + n].view(_np_dtype(t.dtype))
                               .reshape(tuple(t.shape)))
        self.done = None           # the copies' CUDA event

    @staticmethod
    def _key(entries):
        return tuple((n, tuple(t.shape), t.dtype, t.device)
                     for n, t in entries)

    def fits(self, entries):
        return self.key == self._key(entries)

    def fetch(self, entries):
        """Copy ``entries`` into the buffer.  On the card the copies run
        on the copy stream after the current stream's work so far, and
        the current stream waits for them before any later work; the
        host does not wait."""
        with torch.no_grad():
            if self.device.type != "cuda":
                for v, (_, t) in zip(self.views, entries):
                    v.copy_(t)
                return
            with torch.cuda.device(self.device):
                main = torch.cuda.current_stream(self.device)
                ready = torch.cuda.Event()
                ready.record(main)
                copy = _copy_stream(self.device)
                copy.wait_event(ready)
                with torch.cuda.stream(copy):
                    for v, (_, t) in zip(self.views, entries):
                        v.copy_(t, non_blocking=True)
                    self.done = torch.cuda.Event()
                    self.done.record(copy)
                main.wait_event(self.done)

    def wait(self):
        """Block until the copies have landed (their event, not the
        device)."""
        if self.done is not None:
            self.done.synchronize()

    def release(self):
        """Give the pinned buffer back to the pool, with the copies'
        event (the pool hands it out again once that has completed)."""
        if self._handle is not None:
            self._handle.event = self.done
            _storage.Storage.get().free(self._handle)
            self._handle = None
        self.views = self.arrays = ()


def _manifest(step):
    return {
        "train_names": [step._names[i] for i in step._train_idx],
        "aux_names": [step._names[i] for i in step._aux_idx],
        "optimizer": type(step.optimizer).__name__,
        "num_update": int(step._num_update),
        "state_counts": [len(s) for s in step._states],
    }


def _collect_payload(step, staging=None):
    """Start fetching the step's tensors to the host; ``(payload,
    manifest, staging)`` where ``payload`` maps ``p.*``/``s.*``/``a.*``
    entry names to host arrays in ``staging``'s buffer, complete once
    ``staging.wait()`` returns.  ``staging`` is reused when it fits the
    step (else released and a new one made).  Enqueueing the copies —
    and, for a sharded step, gathering its leaves over the mesh — is
    the ONLY part of a snapshot the step loop pays: the writer waits for
    them and does everything downstream.  On a rank other than 0 of a
    sharded step the gather is the whole job: ``payload`` and
    ``staging`` are None (rank 0 writes)."""
    if not step._built:
        raise ValueError("TrainStep has not run yet — nothing to checkpoint")
    _fire("checkpoint.write")
    entries = _entries(step)
    if _dist.rank() != 0:
        if staging is not None:
            staging.release()
        return None, _manifest(step), None
    if staging is not None and not staging.fits(entries):
        staging.release()
        staging = None
    if staging is None:
        staging = _Staging(entries)
    try:
        staging.fetch(entries)
    except BaseException:
        staging.release()
        raise
    payload = {n: a for (n, _), a in zip(entries, staging.arrays)}
    return payload, _manifest(step), staging


def _entry_bytes(a):
    """The canonical bytes a digest is computed over (and verified
    against): C-contiguous raw array bytes, as a uint8 view (no copy
    for a contiguous array)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _apply_bitflip(payload, flip):
    """Honour an armed ``BitFlipInjection``: flip one bit in one entry's
    bytes (digests were already computed, so the corruption is silent to
    the container and visible only to the v1.1 digest check)."""
    key = flip.key
    if key is None:
        params = [k for k in payload if k.startswith("p.")]
        key = max(params or sorted(payload),
                  key=lambda k: payload[k].nbytes)
    a = payload[key]
    buf = bytearray(_entry_bytes(a).tobytes())
    i = (len(buf) // 2 if flip.byte is None else int(flip.byte)) \
        % max(1, len(buf))
    buf[i] ^= 1 << flip.bit
    payload = dict(payload)
    payload[key] = np.frombuffer(bytes(buf), dtype=a.dtype).reshape(a.shape)
    _logger.warning("checkpoint.serialize: injected bit-flip in %r "
                    "(byte %d, bit %d)", key, i, flip.bit)
    return payload


def _fsync_dir(directory):
    """fsync the directory entry so a committed rename survives power
    loss, not just process death.  Platforms that refuse to fsync a
    directory fd (some network filesystems) are skipped."""
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_payload(payload, manifest, fname, trace=None):
    """Serialize + fsync + atomically commit one snapshot (the writer
    half of ``save_train_step``, shared with the async writer thread).

    The v1.1 integrity manifest (format version, per-entry crc32 digest
    and byte size) is stamped here, BEFORE serialization, so anything
    that corrupts the bytes downstream — including the fault-armed
    ``BitFlipInjection`` — is caught by the digest check at load time.
    Durability: payload fsync before the ``os.replace`` commit, directory
    fsync after it.  Returns the payload byte total."""
    man = dict(manifest)
    digests, sizes = {}, {}
    total = 0
    for k, a in payload.items():
        b = _entry_bytes(a)
        digests[k] = zlib.crc32(b) & 0xFFFFFFFF
        sizes[k] = b.nbytes
        total += b.nbytes
    man["format"] = FORMAT_VERSION
    man["digests"] = digests
    man["sizes"] = sizes
    sp = None if trace is None else trace.open("serialize",
                                               parent=trace.root)
    try:
        _fire("checkpoint.serialize")
    except BitFlipInjection as flip:
        payload = _apply_bitflip(payload, flip)
    blob = dict(payload)
    blob[_MANIFEST] = np.frombuffer(
        json.dumps(man).encode(), dtype=np.uint8)
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
        f.flush()
        _fire("checkpoint.fsync")
        os.fsync(f.fileno())
    if sp is not None:
        sp.end()
    sp = None if trace is None else trace.open("commit", parent=trace.root)
    _fire("checkpoint.replace")
    os.replace(tmp, fname)
    _fsync_dir(os.path.dirname(os.path.abspath(fname)))
    if sp is not None:
        sp.end()
    _telemetry.registry().gauge("ckpt_bytes").set(total)
    return total


def save_train_step(step, fname):
    """Write params + optimizer state + aux + step count to ``fname``.

    Layout: ``p.<i>`` trainable param i (in ``step._train_idx`` order),
    ``s.<i>.<j>`` its j-th optimizer state tensor, ``a.<i>`` aux tensor
    i, plus a JSON manifest with the param names for name-checked
    restore and the v1.1 integrity section (format version + per-entry
    crc32 digest and byte size).

    Preemption-safe: the ``.npz`` payload lands in ``fname + '.tmp'`` and
    is committed with ``os.replace`` (atomic on POSIX), so a crash at ANY
    point leaves either the previous complete checkpoint or the new one —
    never a truncated payload under the final name.  Manifest and payload
    live in the one file, so they can never disagree.  Durable: payload
    and directory entry are fsynced around the commit, so a committed
    snapshot survives power loss too.  Returns when the file is
    committed.

    In a gang every rank calls it: a sharded leaf is gathered whole,
    rank 0 writes, and every rank returns after a barrier."""
    t0 = _time.perf_counter()
    tr = _telemetry.maybe_trace("snapshot", server="save_train_step") \
        if _telemetry.ACTIVE else None
    sp = None if tr is None else tr.open("fetch", parent=tr.root)
    payload, manifest, staging = _collect_payload(step)
    try:
        if staging is not None:
            staging.wait()
        if sp is not None:
            sp.end()
        if payload is not None:
            _write_payload(payload, manifest, fname, trace=tr)
        _telemetry.registry().gauge("ckpt_last_snapshot_ms").set(
            round((_time.perf_counter() - t0) * 1e3, 3))
    finally:
        if staging is not None:
            staging.release()
        if tr is not None:
            tr.root.end()
            tr.finish()
    if _dist.num_workers() > 1:
        _dist.barrier()


class _Entries:
    """An open ``.npz`` whose entries are read (decompressed) at most
    once: the digest check and the staging read the same arrays."""

    def __init__(self, z):
        self._z = z
        self.files = z.files
        self._read = {}

    def __getitem__(self, k):
        a = self._read.get(k)
        if a is None:
            a = self._read[k] = self._z[k]
        return a


def _host_tensor(a, like, what, placement=None):
    """Entry ``a`` as a CPU tensor for ``like``: the whole value's shape
    (a sharded ``like`` is one block of it under ``placement``: that
    block is taken), and the dtype of ``like`` (a bfloat16 tensor takes
    a two-byte entry's raw bits), else ``CheckpointMismatchError``."""
    whole = _whole_shape(like, placement)
    if tuple(a.shape) != whole:
        raise CheckpointMismatchError(
            f"checkpoint/model mismatch: {what} is {tuple(a.shape)} in the "
            f"file, {whole} in the model")
    t = _as_tensor(a, like.dtype, what)
    return t if placement is None else placement.local(t)


def _as_tensor(a, dtype, what):
    """Host array ``a`` as a CPU tensor of ``dtype`` (bfloat16 from a
    two-byte entry's raw bits), else ``CheckpointMismatchError``."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                      or a.dtype.name == "bfloat16"):
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == _np_dtype(dtype):
        return torch.from_numpy(a)
    raise CheckpointMismatchError(
        f"checkpoint/model mismatch: {what} is {a.dtype} in the file, "
        f"{dtype} in the model")


def load_train_step(step, fname):
    """Restore a checkpoint into a built TrainStep, in place.

    The step must have been built (one step run, or call it once on a
    sample batch first).  The whole file is verified and staged on the
    host before the step is touched, so a load that is refused (damage,
    or a file of another model) leaves the step as it was; then every
    tensor the step holds — and a captured graph reads — is overwritten
    in place, never rebound.  A sharded step (any mesh layout) takes
    its own block of each whole tensor in the file: every rank of a
    gang calls this, and none waits for another."""
    if not step._built:
        raise ValueError("build the TrainStep (run one step) before restore")
    try:
        npz = np.load(fname)
    except FileNotFoundError:
        raise
    except Exception as exc:          # torn zip container = damage
        _corrupt(fname, f"unreadable container: {exc}")
    with npz:
        z = _Entries(npz)
        try:
            manifest = json.loads(bytes(z[_MANIFEST]).decode())
        except Exception as exc:
            _corrupt(fname, f"manifest missing or unreadable: {exc}")
        # integrity FIRST: a bit-flipped/truncated entry must surface as
        # CheckpointCorruptError (damage) before any model-match verdict
        # or staging — never as a spurious mismatch, never as loaded poison
        _verify_entries(z, manifest, fname)
        staged = _stage(step, z, manifest)
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)
        step._t.fill_(int(manifest["num_update"]))
    num_update = int(manifest["num_update"])
    step._num_update = num_update
    step.optimizer.num_update = num_update
    step._lr_value = None             # the next step() writes the rate


def _stage(step, z, manifest):
    """Every ``(step tensor, host tensor)`` pair of the file, validated
    against the model; raises before anything is copied.  A sharded
    tensor gets this rank's block of the whole entry."""
    names = [step._names[i] for i in step._train_idx]
    saved_names = manifest["train_names"]
    if len(saved_names) != len(names):
        raise CheckpointMismatchError(
            f"checkpoint/model mismatch: file has {len(saved_names)} "
            f"trainable params, model expects {len(names)}")
    # pair by natural order on both sides; counter-normalised names and
    # shapes must then agree pointwise (gluon counters are process-global,
    # so the plain lexicographic storage order is NOT reproducible)
    pairs = list(zip(_natural_order(saved_names), _natural_order(names)))
    for sk, wk in pairs:
        if _norm_name(saved_names[sk]) != _norm_name(names[wk]) or \
                tuple(z[f"p.{sk}"].shape) != _whole_shape(step._train[wk]):
            raise CheckpointMismatchError(
                f"checkpoint/model mismatch: saved param "
                f"{saved_names[sk]!r} {z[f'p.{sk}'].shape} does not match "
                f"model param {names[wk]!r} "
                f"{_whole_shape(step._train[wk])}")
    if manifest["optimizer"] != type(step.optimizer).__name__:
        raise CheckpointMismatchError(
            f"optimizer mismatch: checkpoint={manifest['optimizer']} "
            f"step={type(step.optimizer).__name__}")
    staged = []
    for sk, wk in pairs:
        where = getattr(step._train[wk], "_placement", None)
        staged.append((step._train[wk], _host_tensor(
            z[f"p.{sk}"], step._train[wk], f"param {names[wk]!r}", where)))
        count = int(manifest["state_counts"][sk])
        if count != len(step._states[wk]):
            raise CheckpointMismatchError(
                f"checkpoint/model mismatch: param {saved_names[sk]!r} has "
                f"{count} optimizer state slots in the checkpoint, "
                f"{len(step._states[wk])} in the model (same optimizer "
                f"class configured differently?)")
        for j, s in enumerate(step._states[wk]):
            staged.append((s, _host_tensor(
                z[f"s.{sk}.{j}"], s, f"state {j} of {names[wk]!r}", where)))
    aux_names = [step._names[i] for i in step._aux_idx]
    saved_aux = manifest["aux_names"]
    if len(saved_aux) != len(aux_names):
        raise CheckpointMismatchError(
            f"checkpoint/model mismatch: file has {len(saved_aux)} aux "
            f"arrays, model expects {len(aux_names)}")
    for sk, wk in zip(_natural_order(saved_aux), _natural_order(aux_names)):
        if _norm_name(saved_aux[sk]) != _norm_name(aux_names[wk]) or \
                tuple(z[f"a.{sk}"].shape) != _whole_shape(step._aux[wk]):
            raise CheckpointMismatchError(
                f"checkpoint/model mismatch: saved aux {saved_aux[sk]!r} "
                f"{z[f'a.{sk}'].shape} does not match model aux "
                f"{aux_names[wk]!r} {_whole_shape(step._aux[wk])}")
        staged.append((step._aux[wk], _host_tensor(
            z[f"a.{sk}"], step._aux[wk], f"aux {aux_names[wk]!r}",
            getattr(step._aux[wk], "_placement", None))))
    return staged


# -------------------------------------------------- integrity (v1.1) ------

def _corrupt(path, msg):
    """Record one integrity failure (gauge + flight-recorder dump) and
    raise ``CheckpointCorruptError`` — the single chokepoint every
    verification failure funnels through."""
    _telemetry.registry().gauge("ckpt_verify_failures").add(1)
    _telemetry.flight_trip("ckpt-verify-failure", path=str(path),
                           error=str(msg))
    raise CheckpointCorruptError(f"{path}: {msg}")


def _verify_entries(z, manifest, path, entries=None):
    """Digest-check payload entries against the v1.1 manifest BEFORE any
    bytes are staged.  ``entries`` restricts the check (the params-only
    reader verifies only ``p.*``); None checks every digest-covered entry
    plus flags uncovered strays.  Returns True when digests were checked,
    False for a pre-v1.1 snapshot (no digest section — skipped, logged).
    Raises ``CheckpointCorruptError`` on any missing entry, byte-size
    drift, or crc32 mismatch."""
    _fire("checkpoint.verify")
    digests = manifest.get("digests")
    if digests is None:
        _logger.info("checkpoint %s: pre-v1.1 snapshot (no digest "
                     "section) — integrity check skipped", path)
        return False
    sizes = manifest.get("sizes") or {}
    files = set(getattr(z, "files", ()))
    if entries is None:
        keys = list(digests)
        strays = files - set(digests) - {_MANIFEST}
        if strays:
            _corrupt(path, f"payload entries {sorted(strays)} are not "
                           f"covered by the v1.1 digest section")
    else:
        keys = list(entries)
    for k in keys:
        if k not in digests:
            _corrupt(path, f"entry {k!r} has no digest in the manifest")
        if k not in files:
            _corrupt(path, f"payload entry {k!r} missing from container")
        try:
            b = _entry_bytes(z[k])
        except Exception as exc:
            _corrupt(path, f"payload entry {k!r} unreadable: {exc}")
        if k in sizes and b.nbytes != int(sizes[k]):
            _corrupt(path, f"payload entry {k!r} is {b.nbytes} bytes, "
                           f"manifest says {sizes[k]}")
        if (zlib.crc32(b) & 0xFFFFFFFF) != int(digests[k]):
            _corrupt(path, f"crc32 mismatch on payload entry {k!r} "
                           f"(bytes corrupted after write, or flipped "
                           f"between digest and serialize)")
    return True


def verify_checkpoint(path):
    """Deep-check one committed snapshot WITHOUT constructing a
    TrainStep: container readability, manifest parse, and (v1.1) every
    entry's byte size + crc32 digest.  Returns the parsed manifest dict
    on success; raises ``CheckpointCorruptError`` on any damage
    (``FileNotFoundError`` passes through untouched — a pruned path is
    *stale*, not corrupt).  Pre-v1.1 snapshots verify container
    readability only (every entry decompressed), logged as such.

    This is the operator / CI spelling: ``verify_checkpoint(p)`` over a
    retention directory proves the snapshot stream intact end to end."""
    try:
        z = np.load(path)
    except FileNotFoundError:
        raise
    except Exception as exc:
        _corrupt(path, f"unreadable container: {exc}")
    try:
        files = set(z.files)
        if _MANIFEST not in files:
            _corrupt(path, "no __manifest__ entry — not a v1 snapshot")
        try:
            manifest = json.loads(bytes(z[_MANIFEST]).decode())
        except Exception as exc:
            _corrupt(path, f"manifest unreadable: {exc}")
        if not _verify_entries(z, manifest, path):
            # pre-v1.1: no digests to check, but still decompress every
            # entry so zip-level truncation cannot hide
            for k in sorted(files - {_MANIFEST}):
                try:
                    z[k]
                except Exception as exc:
                    _corrupt(path, f"payload entry {k!r} unreadable: "
                                   f"{exc}")
        return manifest
    finally:
        z.close()


# ---------------------------------------------------------------- v2 ------

V2_FORMAT = "port-v2"


def _rank_file(directory, rank, world):
    return os.path.join(directory, f"rank-{rank}-of-{world}.npz")


def _blocks(placement, shape, world):
    """Each rank's block of a leaf of ``shape`` under ``placement`` (None:
    whole on every rank), as ``[start, size]`` per dimension, in rank
    order — the offsets ``Placement.local`` takes, major axis first."""
    out = []
    for r in range(world):
        box = [[0, int(n)] for n in shape]
        if placement is not None:
            coords = placement.mesh.coords(r)
            for d, axes in placement.split.items():
                for a in axes:
                    size = box[d][1] // placement.mesh.shape[a]
                    box[d] = [box[d][0] + coords[a] * size, size]
        out.append(box)
    return out


def _writes(placement, rank):
    """Whether ``rank`` writes its block of an entry under ``placement``:
    its coordinate is 0 on every mesh axis the entry is not split over
    (None, a whole entry: rank 0)."""
    if placement is None:
        return rank == 0
    coords = placement.mesh.coords(rank)
    return all(coords[a] == 0 for a in placement.mesh.axis_names
               if a not in placement.axes)


def _v2_manifest(step, world, save_id):
    """The v2 directory's manifest: the JAX package's keys, the step
    count, the save's id and the layout (each entry's spec and the
    blocks written, with the rank that wrote each)."""
    leaves = {}
    for name, t, where in _placed_entries(step):
        boxes = _blocks(where, _whole_shape(t, where), world)
        leaves[name] = {
            "spec": None if where is None else [
                list(e) if isinstance(e, tuple) else e for e in where.spec],
            "blocks": [[r, box] for r, box in enumerate(boxes)
                       if _writes(where, r)]}
    return {
        "format": V2_FORMAT,
        "save_id": save_id,
        "train_names": [step._names[i] for i in step._train_idx],
        "aux_names": [step._names[i] for i in step._aux_idx],
        "optimizer": type(step.optimizer).__name__,
        "shapes": [list(_whole_shape(t)) for t in step._train],
        "aux_shapes": [list(_whole_shape(t)) for t in step._aux],
        "state_counts": [len(s) for s in step._states],
        "num_update": int(step._num_update),
        "layout": {"mesh": {a: int(n) for a, n in step.mesh.shape.items()},
                   "world": world, "entries": leaves},
    }


def _write_json(path, obj):
    """``obj`` to ``path``, temp-then-rename, fsynced with its directory."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


class ShardedSave:
    """What ``save_train_step_sharded`` returns (the counterpart of the
    orbax checkpointer the JAX package returns).  ``wait_until_finished()``
    blocks until this rank's file is committed and then, in a gang where
    every rank calls it, until every rank's is; then rank 0 commits the
    directory's manifest, and every rank returns once it has.  Until
    then the directory has no manifest and does not load.  Raises the
    write's error if this rank's failed, or a ``RuntimeError`` if
    another rank's did (no manifest is written)."""

    def __init__(self, fname, manifest_path, manifest):
        self.fname = fname
        self._manifest = (manifest_path, manifest)
        self._done = threading.Event()
        self._committed = False
        self.error = None

    def _finish(self, exc):
        self.error = exc
        self._done.set()

    def wait_until_finished(self, timeout=None):
        if not self._done.wait(timeout):
            return False
        if not self._committed:
            failed = int(_dist.all_sum(np.array(
                [self.error is not None], np.int64))[0])
            if failed == 0 and self._manifest[1] is not None:
                _write_json(*self._manifest)
            if _dist.num_workers() > 1:
                _dist.barrier()
            self._committed = True
            if self.error is None and failed:
                raise RuntimeError(
                    f"v2 save: {failed} rank file(s) failed to commit; "
                    f"{self._manifest[0]} was not written")
        if self.error is not None:
            raise self.error
        return True


_V2_WRITER = None
_V2_WRITER_LOCK = threading.Lock()


def _v2_writer():
    """The process's writer thread for v2 saves (an ``AsyncSnapshotter``
    that never skips: each save is queued behind the last)."""
    global _V2_WRITER
    with _V2_WRITER_LOCK:
        if _V2_WRITER is None:
            _V2_WRITER = AsyncSnapshotter(max_pending=1 << 30)
        return _V2_WRITER


def save_train_step_sharded(step, directory, async_save=True):
    """v2: every rank writes the blocks it owns of the step's state, with
    no gather, to ``<directory>/rank-<r>-of-<n>.npz``; rank 0 writes
    ``<directory>.manifest.json`` once every rank's file has committed
    (the port's own format: see the module docstring).  Every rank of a
    gang calls it.

    The step pays for enqueueing the device-to-host copies of its
    blocks; the file is serialized, fsynced and committed by the
    process's writer thread.  With ``async_save`` the call returns at
    once, and ``.wait_until_finished()`` on the returned ``ShardedSave``
    (every rank calls it) commits the directory.  Without it the call
    returns when the directory is committed."""
    if not step._built:
        raise ValueError("TrainStep has not run yet — nothing to checkpoint")
    _fire("checkpoint.write")
    path = os.path.abspath(str(directory))
    rank, world = _dist.rank(), _dist.num_workers()
    save_id = int(_dist.broadcast(np.array(
        [int.from_bytes(os.urandom(7), "little")], np.int64))[0])
    mpath = path + ".manifest.json"
    man = None
    os.makedirs(path, exist_ok=True)
    if rank == 0:
        man = _v2_manifest(step, world, save_id)
        if os.path.exists(mpath):
            os.remove(mpath)
            _fsync_dir(os.path.dirname(path))
    entries = [(n, t.detach()) for n, t, where in _placed_entries(step)
               if _writes(where, rank)]
    staging = _Staging(entries)
    try:
        staging.fetch(entries)
    except BaseException:
        staging.release()
        raise
    payload = {n: a for (n, _), a in zip(entries, staging.arrays)}
    manifest = {"format": V2_FORMAT, "save_id": save_id, "rank": rank,
                "world": world, "num_update": int(step._num_update)}
    handle = ShardedSave(_rank_file(path, rank, world), mpath, man)
    _v2_writer()._submit(payload, manifest, handle.fname, staging,
                         handle._finish)
    if not async_save:
        handle.wait_until_finished()
    return handle


def _box_overlap(a, b):
    """The overlap of two ``[start, size]`` boxes, or None."""
    out = []
    for (sa, na), (sb, nb) in zip(a, b):
        lo, hi = max(sa, sb), min(sa + na, sb + nb)
        if hi <= lo:
            return None
        out.append([lo, hi - lo])
    return out


class _RankFiles:
    """The saved ranks' files, each opened and its manifest read at first
    use and checked against the directory's (the same save); every entry
    read is digest-checked first."""

    def __init__(self, path, man):
        self.path = path
        self.world = int(man["layout"]["world"])
        self.expect = {"num_update": int(man["num_update"]),
                       "world": self.world, "save_id": man["save_id"]}
        self._open = {}                  # rank -> (npz, _Entries, manifest)

    def entry(self, rank, key):
        fname = _rank_file(self.path, rank, self.world)
        hit = self._open.get(rank)
        if hit is None:
            try:
                npz = np.load(fname)
            except FileNotFoundError:
                raise
            except Exception as exc:        # torn zip container = damage
                _corrupt(fname, f"unreadable container: {exc}")
            z = _Entries(npz)
            hit = self._open[rank] = (npz, z, None)
            try:
                hit = self._open[rank] = (
                    npz, z, json.loads(bytes(z[_MANIFEST]).decode()))
            except Exception as exc:
                _corrupt(fname, f"manifest missing or unreadable: {exc}")
            for k, want in self.expect.items():
                if hit[2].get(k) != want:
                    _corrupt(fname, f"a rank file of another save: its {k} "
                                    f"is {hit[2].get(k)!r}, the directory's "
                                    f"manifest says {want!r} (a re-save "
                                    f"cut short?)")
        _, z, manifest = hit
        _verify_entries(z, manifest, fname, entries=[key])
        return z[key]

    def close(self):
        for npz, _, _ in self._open.values():
            npz.close()
        self._open = {}


def _read_blocks(files, saved, key, like, placement, what):
    """This rank's block of entry ``key`` (whole where ``placement`` is
    None), assembled on the host from the saved blocks that overlap it."""
    shape = _whole_shape(like, placement)
    rank = _dist.rank() if placement is not None else 0
    mine = _blocks(placement, shape, rank + 1)[rank]
    out = torch.empty(tuple(n for _, n in mine), dtype=like.dtype)
    for r, box in saved["blocks"]:
        ov = _box_overlap(box, mine)
        if ov is None:
            continue
        a = files.entry(r, key)
        if list(a.shape) != [n for _, n in box]:
            _corrupt(_rank_file(files.path, r, files.world),
                     f"entry {key!r} is {list(a.shape)}, the manifest's "
                     f"layout says {[n for _, n in box]}")
        src = tuple(slice(s - b[0], s - b[0] + n)
                    for (s, n), b in zip(ov, box))
        dst = tuple(slice(s - m[0], s - m[0] + n)
                    for (s, n), m in zip(ov, mine))
        out[dst] = _as_tensor(a[src], like.dtype, what)
    return out


def load_train_step_sharded(step, directory):
    """Restore a v2 directory (``save_train_step_sharded``, any layout)
    into a BUILT TrainStep (any layout), in place.  Every rank of a gang
    calls it.

    Names pair in natural order (Gluon's name counters are
    process-global), names, shapes, the optimizer and the state slots
    are validated as the JAX package validates them, and each rank reads
    only the saved blocks that overlap the blocks it holds, then copies
    into the step's tensors (a captured graph keeps reading them).
    Everything is staged on the host before the step is touched, and
    the ranks of a gang agree that every one of them staged its blocks:
    a refused load (a damaged rank file, or one of another save) leaves
    every rank's step as it was.  A directory the JAX package wrote
    (orbax) is refused with a ``ValueError``."""
    if not step._built:
        raise ValueError("build the TrainStep (run one step) before restore")
    path = os.path.abspath(str(directory))
    mpath = path + ".manifest.json"
    if not os.path.exists(mpath):
        raise ValueError(
            f"missing {mpath}: v2 checkpoints are written with a manifest "
            f"(save_train_step_sharded); cannot validate or remap without it")
    with open(mpath) as f:
        man = json.load(f)
    if man.get("format") != V2_FORMAT or "layout" not in man:
        raise ValueError(
            f"{path}: a v2 directory the JAX package wrote (orbax's tree; "
            f"its manifest has no port-v2 layout), which the port does not "
            f"read; save it with mxnet_tpu's save_train_step (v1.1, one "
            f"file) and load that with load_train_step")
    names = [step._names[i] for i in step._train_idx]
    saved_names = man["train_names"]
    if len(saved_names) != len(names):
        raise ValueError(
            f"checkpoint/model mismatch: file has {len(saved_names)} "
            f"trainable params, model expects {len(names)}")
    pairs = list(zip(_natural_order(saved_names), _natural_order(names)))
    for sk, wk in pairs:
        if _norm_name(saved_names[sk]) != _norm_name(names[wk]) \
                or tuple(man["shapes"][sk]) != \
                _whole_shape(step._train[wk]):
            raise ValueError(
                f"checkpoint/model mismatch: saved {saved_names[sk]!r} "
                f"{man['shapes'][sk]} vs model {names[wk]!r} "
                f"{_whole_shape(step._train[wk])}")
    if man["optimizer"] != type(step.optimizer).__name__:
        raise ValueError(
            f"optimizer mismatch: checkpoint={man['optimizer']} "
            f"step={type(step.optimizer).__name__}")
    aux_names = [step._names[i] for i in step._aux_idx]
    saved_aux = man["aux_names"]
    if len(saved_aux) != len(aux_names):
        raise ValueError(
            f"checkpoint/model mismatch: file has {len(saved_aux)} aux "
            f"arrays, model expects {len(aux_names)}")
    aux_pairs = list(zip(_natural_order(saved_aux),
                         _natural_order(aux_names)))
    for sk, wk in aux_pairs:
        if _norm_name(saved_aux[sk]) != _norm_name(aux_names[wk]) \
                or tuple(man["aux_shapes"][sk]) != \
                _whole_shape(step._aux[wk]):
            raise ValueError(
                f"checkpoint/model mismatch: saved aux {saved_aux[sk]!r} "
                f"{man['aux_shapes'][sk]} vs model {aux_names[wk]!r} "
                f"{_whole_shape(step._aux[wk])}")
    for sk, wk in pairs:
        if man["state_counts"][sk] != len(step._states[wk]):
            raise ValueError(
                f"checkpoint/model mismatch: param {saved_names[sk]!r} has "
                f"{man['state_counts'][sk]} optimizer state slots in the "
                f"checkpoint, {len(step._states[wk])} in the model (same "
                f"optimizer class configured differently?)")
    files = _RankFiles(path, man)
    saved = man["layout"]["entries"]
    staged, err = [], None
    try:
        for sk, wk in pairs:
            t = step._train[wk]
            where = getattr(t, "_placement", None)
            staged.append((t, _read_blocks(files, saved[f"p.{sk}"], f"p.{sk}",
                                           t, where, f"param {names[wk]!r}")))
            for j, s in enumerate(step._states[wk]):
                key = f"s.{sk}.{j}"
                staged.append((s, _read_blocks(
                    files, saved[key], key, s, where,
                    f"state {j} of {names[wk]!r}")))
        for sk, wk in aux_pairs:
            t = step._aux[wk]
            staged.append((t, _read_blocks(
                files, saved[f"a.{sk}"], f"a.{sk}", t,
                getattr(t, "_placement", None), f"aux {aux_names[wk]!r}")))
    except Exception as exc:
        err = exc
    finally:
        files.close()
    # every rank of a gang refuses together, before any touches its step
    failed = int(_dist.all_sum(np.array([err is not None], np.int64))[0])
    if err is not None:
        raise err
    if failed:
        raise CheckpointCorruptError(
            f"{path}: {failed} other rank(s) could not read their blocks; "
            f"the step is left as it was")
    num_update = int(man["num_update"])
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)
        step._t.fill_(num_update)
    step._num_update = num_update
    step.optimizer.num_update = num_update
    step._lr_value = None             # the next step() writes the rate


# ------------------------------------------------- retention / discovery --

def list_checkpoints(directory, prefix="ckpt"):
    """``(num_update, path)`` pairs for every ``<prefix>-<n>.npz`` in
    ``directory``, ascending by step.  Orphan ``.tmp`` files (a crash
    mid-write) are ignored — they were never committed.  Delegates to
    ``elastic.scan_checkpoints`` — the one committed-name parser, shared
    with the (torch-free) supervisor's progress accounting."""
    return _elastic.scan_checkpoints(directory, prefix)


def latest_checkpoint(directory, prefix="ckpt"):
    """Newest committed ``(num_update, path)``, or None when empty."""
    return _elastic.latest_checkpoint(directory, prefix)


def latest_step(directory, prefix="ckpt"):
    """The newest committed snapshot's step count, or None when the
    directory holds none — the progress probe the elastic supervisor's
    restart-budget accounting reads (``elastic.latest_committed_step``
    is the stdlib spelling the supervisor process itself uses)."""
    return _elastic.latest_committed_step(directory, prefix)


def wait_for_new(directory, last_seen=None, timeout=None, prefix="ckpt",
                 poll=0.1):
    """Block until ``directory`` holds a checkpoint NEWER than
    ``last_seen`` (a ``num_update``; ``None`` accepts any); returns the
    newest ``(num_update, path)`` pair, or ``None`` on timeout.

    Pure polling over the committed-name namespace
    (``list_checkpoints``), so it only ever sees atomically-committed
    snapshots — a mid-write ``.tmp`` is invisible by construction, and
    the returned path is complete the moment it is returned."""
    t_end = None if timeout is None else _time.monotonic() + float(timeout)
    while True:
        ck = latest_checkpoint(directory, prefix)
        if ck is not None:
            num_update, path = ck
            if last_seen is None or num_update > last_seen:
                return num_update, path
        if t_end is not None:
            remaining = t_end - _time.monotonic()
            if remaining <= 0:
                return None
            _time.sleep(min(float(poll), remaining))
        else:
            _time.sleep(float(poll))


def load_snapshot_params(fname):
    """Read ONLY the trainable params out of a v1 snapshot, without a
    TrainStep: ``(params, names)`` where ``params`` is a list of host
    arrays in saved (``p.<k>``) order (a bfloat16 parameter as its
    two-byte ``V2`` form) and ``names`` the matching manifest names.

    Integrity: the ``p.*`` entries are digest-verified (v1.1) before
    anything is returned — a corrupt snapshot raises
    ``CheckpointCorruptError``.  ``FileNotFoundError`` propagates
    untouched: a path pruned between discovery and read is *stale*
    (re-poll), not bad."""
    try:
        npz = np.load(fname)
    except FileNotFoundError:
        raise
    except Exception as exc:          # torn zip container = damage
        _corrupt(fname, f"unreadable container: {exc}")
    with npz:
        z = _Entries(npz)
        try:
            manifest = json.loads(bytes(z[_MANIFEST]).decode())
        except Exception as exc:
            _corrupt(fname, f"manifest missing or unreadable: {exc}")
        names = list(manifest["train_names"])
        keys = [f"p.{k}" for k in range(len(names))]
        _verify_entries(z, manifest, fname, entries=keys)
        params = []
        for k in keys:
            try:
                params.append(z[k])
            except Exception as exc:
                _corrupt(fname, f"payload entry {k!r} unreadable: {exc}")
        return params, names


def resume_latest(step, directory, prefix="ckpt"):
    """Restore the newest loadable checkpoint in ``directory`` into a
    BUILT TrainStep; returns its ``num_update``, or None when the
    directory holds no usable checkpoint (fresh start).

    A checkpoint that cannot be READ (truncated zip, corrupt json,
    truncated inner array — e.g. the process died while an external copy
    was happening) is skipped with a warning and the next-older one is
    tried: preemption recovery must not be wedged by one bad file.  The
    same damage-vs-user-error split applies to VALIDATION failures: a
    committed file (the marker name exists) whose payload fails the
    model match is only a user error when the mismatch is *systematic* —
    if an older snapshot of the same run restores cleanly, the
    mismatching file was damaged in place (partial overwrite, botched
    external restore) and is skipped as damage, not reported as user
    error.  Only when NO candidate matches does the newest file's
    ``CheckpointMismatchError`` raise — a genuinely wrong model must
    never silently resume."""
    if not step._built:
        raise ValueError("build the TrainStep (run one step) before "
                         "resume_latest")
    mismatch = None
    skipped = []
    for num_update, path in reversed(list_checkpoints(directory, prefix)):
        try:
            load_train_step(step, path)
        except CheckpointMismatchError as exc:
            # deferred verdict: user error only if every candidate agrees
            if mismatch is None:
                mismatch = exc
            skipped.append((path, exc))
            continue
        except Exception as exc:   # truncated/corrupt in ANY layer (zip,
            # manifest json, inner .npy header): damage, not user error
            _logger.warning("resume_latest: skipping unreadable checkpoint "
                            "%s (%s)", path, exc)
            continue
        for bad_path, exc in skipped:    # an older file restored: the
            # newer mismatches were per-file damage after all
            _logger.warning(
                "resume_latest: skipped damaged checkpoint %s — its "
                "payload fails validation (%s) but %s restores cleanly, "
                "so this is file damage, not a model mismatch",
                bad_path, exc, path)
        return num_update
    if mismatch is not None:
        raise mismatch
    return None


# ------------------------------------------------------ async pipeline ----

_LIVE_LOCK = threading.Lock()
_LIVE_SNAPSHOTTERS = weakref.WeakSet()


def flush_pending(timeout=None):
    """Drain every live ``AsyncSnapshotter`` in the process: returns True
    when all queued snapshot writes have committed (or none exist), False
    on timeout.  The SIGTERM / nonfinite-abort exit paths call this so a
    snapshot training believed saved is never lost in the queue — the
    elastic supervisor's progress accounting reads the directory, not the
    queue."""
    with _LIVE_LOCK:
        snaps = list(_LIVE_SNAPSHOTTERS)
    ok = True
    for s in snaps:
        ok = s.wait_until_finished(timeout=timeout) and ok
    return ok


class AsyncSnapshotter:
    """Non-blocking snapshot writes: the step loop pays ONLY enqueueing the
    device→host copies; a background writer thread waits for them,
    serializes, fsyncs, and atomically commits through the same
    ``_write_payload`` as the synchronous path (identical v1.1 format,
    identical durability).

    The queue is bounded (``max_pending``, default 1 → double buffer:
    one snapshot being written while training goes on).  When the
    writer is still busy at the next save point the snapshot is SKIPPED
    — counted in ``snapshots_skipped`` and the ``ckpt_snapshots_skipped``
    gauge — rather than stalling training: a slow disk degrades snapshot
    *frequency*, never step time.  Each write in flight holds one host
    staging buffer (pinned on the card), handed back when its write
    ends and reused by a later save, so the bound also caps the pinned
    memory.  ``wait_until_finished()`` drains; every live instance is
    registered so the process-wide ``flush_pending()`` (SIGTERM /
    nonfinite-abort paths) can drain them all.  Writer-thread failures —
    a copy that failed on the card among them — are latched in
    ``errors`` and logged; the step loop is never interrupted by a
    failed background write."""

    def __init__(self, max_pending=1, on_commit=None):
        self.max_pending = max(1, int(max_pending))
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._q = _queue.Queue()
        self._pending = 0
        self._skipped = 0
        self._written = 0
        self._errors = []
        self._spare = []               # staging buffers of finished writes
        self._closed = False
        self._on_commit = on_commit
        self._thread = threading.Thread(target=self._run,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()
        with _LIVE_LOCK:
            _LIVE_SNAPSHOTTERS.add(self)

    # -- step-loop side ----------------------------------------------------
    def save(self, step, fname):
        """Snapshot ``step`` toward ``fname``.  Blocks only while the
        device→host copies are enqueued; returns True when the write was
        enqueued, False when it was skipped because ``max_pending``
        writes are already in flight.  The ``ckpt_last_snapshot_ms``
        gauge records the stall THIS call cost the step loop."""
        t0 = _time.perf_counter()
        gang = _dist.num_workers() > 1 and step._built and _sharded(step)
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncSnapshotter is closed")
            busy = self._pending >= self.max_pending
            if gang:
                # the gather is a collective: every rank skips, or none
                flag = torch.tensor([int(busy)], dtype=torch.int32)
                busy = bool(_dist.all_reduce_(flag, op="max")[0])
            if busy:
                self._skipped += 1
                _telemetry.registry().gauge(
                    "ckpt_snapshots_skipped").set(self._skipped)
                _logger.warning(
                    "AsyncSnapshotter: skipping snapshot %s — %d write(s) "
                    "still in flight (slow disk? raise max_pending or "
                    "lower the snapshot rate)", fname, self._pending)
                return False
            self._pending += 1
            staging = self._spare.pop() if self._spare else None
            _telemetry.registry().gauge(
                "ckpt_pending_writes").set(self._pending)
        try:
            tr = _telemetry.maybe_trace("snapshot", server="async") \
                if _telemetry.ACTIVE else None
            sp = None if tr is None else tr.open("fetch", parent=tr.root)
            payload, manifest, staging = _collect_payload(step, staging)
            if sp is not None:
                sp.end()
            if tr is not None:
                tr.root.end()
                tr.finish()
        except BaseException:
            with self._idle:
                self._pending -= 1
                self._idle.notify_all()
            raise
        if payload is not None:
            self._q.put((payload, manifest, fname, staging, None))
        else:                       # a rank that does not write: the
            with self._idle:        # gather was the whole job
                self._pending -= 1
                self._idle.notify_all()
        _telemetry.registry().gauge("ckpt_last_snapshot_ms").set(
            round((_time.perf_counter() - t0) * 1e3, 3))
        return True

    def _submit(self, payload, manifest, fname, staging, done):
        """Queue one prepared write (never skipped); ``done(exc)`` runs
        on the writer thread when it has committed (``exc`` None) or
        failed."""
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncSnapshotter is closed")
            self._pending += 1
        self._q.put((payload, manifest, fname, staging, done))

    def wait_until_finished(self, timeout=None):
        """Block until every enqueued snapshot has committed; True when
        drained, False on timeout."""
        deadline = None if timeout is None \
            else _time.monotonic() + float(timeout)
        with self._idle:
            while self._pending > 0:
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True

    def close(self, timeout=None):
        """Drain, stop the writer thread, free the staging buffers,
        deregister (idempotent)."""
        with self._lock:
            already = self._closed
            self._closed = True
        if already:
            return
        self.wait_until_finished(timeout=timeout)
        self._q.put(None)
        self._thread.join(timeout=10.0 if timeout is None else timeout)
        with self._lock:
            spare, self._spare = self._spare, []
        for staging in spare:
            staging.release()
        with _LIVE_LOCK:
            _LIVE_SNAPSHOTTERS.discard(self)

    # -- introspection (locked: written by the writer thread) --------------
    @property
    def pending_writes(self):
        with self._lock:
            return self._pending

    @property
    def snapshots_skipped(self):
        with self._lock:
            return self._skipped

    @property
    def snapshots_written(self):
        with self._lock:
            return self._written

    @property
    def errors(self):
        """``(fname, exception)`` pairs from failed background writes."""
        with self._lock:
            return list(self._errors)

    # -- writer thread -----------------------------------------------------
    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            payload, manifest, fname, staging, done = item
            tr = _telemetry.maybe_trace("snapshot", server="ckpt-writer") \
                if _telemetry.ACTIVE else None
            failed = None
            try:
                staging.wait()
                _write_payload(payload, manifest, fname, trace=tr)
                with self._lock:
                    self._written += 1
                cb = self._on_commit
                if cb is not None:
                    try:
                        cb(fname)
                    except Exception:
                        _logger.exception(
                            "AsyncSnapshotter: on_commit hook failed "
                            "for %s", fname)
            except Exception as exc:
                failed = exc
                _logger.error("AsyncSnapshotter: background write of %s "
                              "failed: %s", fname, exc)
                with self._lock:
                    self._errors.append((fname, exc))
            finally:
                if tr is not None:
                    tr.root.end()
                    tr.finish()
                if done is not None:
                    done(failed)
                    staging.release()
                with self._idle:
                    if done is None:
                        self._spare.append(staging)
                    self._pending -= 1
                    _telemetry.registry().gauge(
                        "ckpt_pending_writes").set(self._pending)
                    self._idle.notify_all()


class CheckpointManager:
    """Periodic, retained, preemption-safe checkpoints for a TrainStep.

    ``every_n_steps`` drives ``maybe_save()`` (call it after each step);
    ``keep_last`` bounds disk by deleting the oldest snapshots after each
    successful save.  Writes go through ``save_train_step`` so every
    snapshot is atomic; stale ``.tmp`` orphans from crashed writes are
    cleaned opportunistically.

    ``async_save=True`` routes writes through an ``AsyncSnapshotter``:
    ``save()``/``maybe_save()`` block only while the device→host copies
    are enqueued, and the commit + retention pruning happen on the writer
    thread.  A save landing while ``max_pending`` writes are still in
    flight is skipped (see ``snapshots_skipped``).  Call
    ``wait_until_finished()`` before reading the directory, and
    ``close()`` when done (the module-level ``flush_pending()`` drains
    every live snapshotter on SIGTERM / nonfinite-abort exits).
    """

    def __init__(self, step, directory, every_n_steps=0, keep_last=3,
                 prefix="ckpt", async_save=False, max_pending=1):
        self.step = step
        self.directory = str(directory)
        self.every_n_steps = int(every_n_steps)
        self.keep_last = max(1, int(keep_last))
        self.prefix = prefix
        self._last_saved = None
        # retention runs on the caller thread (sync) or the writer thread
        # (async on_commit) — one lock so concurrent prunes never race
        self._retain_lock = threading.Lock()
        self._snapshotter = AsyncSnapshotter(
            max_pending=max_pending,
            on_commit=lambda _fname: self._retain()) if async_save else None
        os.makedirs(self.directory, exist_ok=True)

    def _fname(self, num_update):
        return os.path.join(self.directory,
                            f"{self.prefix}-{num_update:08d}.npz")

    def save(self):
        """Snapshot now; returns the committed path — or, async, the
        DESTINED path (committed once the writer lands it; None when the
        bounded queue skipped this save)."""
        n = int(self.step._num_update)
        fname = self._fname(n)
        if self._snapshotter is not None:
            if not self._snapshotter.save(self.step, fname):
                return None
            self._last_saved = n
            return fname
        save_train_step(self.step, fname)
        self._last_saved = n
        self._retain()
        return fname

    def maybe_save(self):
        """Snapshot iff ``every_n_steps`` divides the step count (and this
        step was not already saved); returns the path or None."""
        n = int(self.step._num_update)
        if self.every_n_steps <= 0 or n == 0 or n % self.every_n_steps:
            return None
        if self._last_saved == n:
            return None
        return self.save()

    def checkpoints(self):
        return list_checkpoints(self.directory, self.prefix)

    def latest_step(self):
        """Newest committed snapshot's step, or None when empty — the
        one-call progress probe (the supervisor-side twin is
        ``elastic.latest_committed_step`` on the same directory)."""
        return latest_step(self.directory, self.prefix)

    def resume_latest(self):
        """``resume_latest(step, directory)`` with this manager's step."""
        return resume_latest(self.step, self.directory, self.prefix)

    def wait_for_new(self, last_seen=None, timeout=None, poll=0.1):
        """``wait_for_new`` against this manager's directory/prefix."""
        return wait_for_new(self.directory, last_seen=last_seen,
                            timeout=timeout, prefix=self.prefix, poll=poll)

    def wait_until_finished(self, timeout=None):
        """Drain pending async writes (no-op when sync); True when the
        directory reflects every accepted ``save()``."""
        if self._snapshotter is None:
            return True
        return self._snapshotter.wait_until_finished(timeout=timeout)

    def close(self, timeout=None):
        """Drain and stop the async writer (no-op when sync)."""
        if self._snapshotter is not None:
            self._snapshotter.close(timeout=timeout)

    @property
    def snapshots_skipped(self):
        """Saves dropped by the async bounded queue (0 when sync)."""
        if self._snapshotter is None:
            return 0
        return self._snapshotter.snapshots_skipped

    @property
    def write_errors(self):
        """``(fname, exception)`` pairs from failed async writes."""
        if self._snapshotter is None:
            return []
        return self._snapshotter.errors

    def _retain(self):
        if _dist.rank() != 0:
            return
        with self._retain_lock:
            cks = self.checkpoints()
            newest = cks[-1][1] if cks else None
            for _, path in cks[:-self.keep_last]:
                if path == newest:
                    # never prune the newest committed snapshot — it is
                    # the one a wait_for_new watcher was just handed and
                    # the one resume must always find
                    continue
                try:
                    os.remove(path)
                except OSError:
                    pass
            for name in os.listdir(self.directory):
                if name.startswith(self.prefix + "-") and \
                        name.endswith(".tmp"):
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except OSError:
                        pass
