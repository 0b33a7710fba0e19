"""Multi-process bring-up over ``torch.distributed`` (the port of
``mxnet_tpu/distributed.py``).

The DMLC_* env contract of the reference's launcher is kept:
``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` name the coordinator (a
``TCPStore`` that rank 0 hosts), ``DMLC_NUM_WORKER`` the world size and
``DMLC_WORKER_ID`` this process's rank; ``python -m
mxnet_tpu_torch.launch`` exports them.  Every process is a worker: one
process per card, one rank per process.

**Backend rule.**  Each rank writes the identity of its card (its UUID)
into the store: when every rank has a card of its own, the process
group runs over NCCL; when ranks share one card, or there is no card
(the launcher's ``--platform cpu`` hides them), over gloo.  There is no
other case, and an NCCL failure raises: it is never retried over gloo.
Rank r takes card ``r % torch.cuda.device_count()`` of the cards it sees
(``torch.cuda.set_device``), so the default context is the rank's card.

A gloo collective on a card's tensor goes through the host (a copy into
a pinned host buffer, reused from call to call, and back); an NCCL one
runs on the card, and may be captured in a CUDA graph.

``init()`` with no env and no arguments is a no-op world of one, so
scripts call it unconditionally.  With a coordinator and a world of one
(``-n 1`` under the launcher) it makes a process group of one rank, so
the NCCL communicator and the collectives of a one-card run are the
real ones (the JAX package's ``init`` returns without a service there).

A process that joined leaves at exit (``atexit``): ``shutdown()`` runs
before the interpreter tears down, so the group and rank 0's store are
destroyed while Python still runs them.  Left to the interpreter's own
teardown, rank 0's store thread could be destroyed unjoined and the
process abort ("terminate called without an active exception") after
its work was done, failing its gang.
"""
from __future__ import annotations

import atexit
import datetime
import logging
import math
import os
import socket
import threading
import time

import numpy as np
import torch

from . import fault as _fault

__all__ = ["init", "shutdown", "rank", "num_workers", "barrier",
           "all_sum", "all_gather", "broadcast", "backend", "device",
           "is_initialized"]

_logger = logging.getLogger(__name__)

_state = {"store": None, "backend": None, "device": None, "rank": 0,
          "world": 1}
_epoch = 0                # completed init -> shutdown round trips
_leave_registered = False
_barrier_seq = {}         # name -> calls so far (same order on every rank)


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized():
    """Whether this process is a rank of a process group."""
    return _state["store"] is not None


def _card_identity(index):
    """A string naming the physical card ``index`` of this process."""
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return f"{socket.gethostname()}:{uuid}"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    cards = [c.strip() for c in visible.split(",") if c.strip()]
    return f"{socket.gethostname()}:{cards[index] if cards else index}"


def _pick_backend(store, process_id, num_processes, dev):
    """The backend rule over the cards every rank wrote to ``store``."""
    ident = "cpu" if dev.type == "cpu" else _card_identity(dev.index)
    store.set(f"mxtpu:card:{_epoch}:{process_id}", ident)
    cards = [store.get(f"mxtpu:card:{_epoch}:{r}").decode()
             for r in range(num_processes)]
    if any(c == "cpu" for c in cards):
        return "gloo", cards
    return ("nccl" if len(set(cards)) == num_processes else "gloo"), cards


def _held_store_socket(port):
    """The descriptor of the launcher's listening socket on ``port``,
    which rank 0 inherits (``elastic.STORE_FD_ENV``), or None.  Taken
    once: a retried connect, or a later ``init``, binds the port
    itself."""
    from .elastic import STORE_FD_ENV

    fd = os.environ.pop(STORE_FD_ENV, None)
    if not fd:
        return None
    try:
        with socket.socket(fileno=os.dup(int(fd))) as s:
            if s.getsockname()[1] != port:
                return None
    except (OSError, ValueError):
        return None
    return int(fd)


def init(coordinator=None, num_processes=None, process_id=None,
         retries=None, timeout=None, backoff_base=0.5):
    """Join the process group from the arguments or the DMLC_* env.

    Reads, in priority order, the arguments, then ``DMLC_PS_ROOT_URI`` /
    ``DMLC_PS_ROOT_PORT`` / ``DMLC_NUM_WORKER`` / ``DMLC_WORKER_ID``.
    Without a coordinator or a worker count it is a no-op.  Idempotent.

    Bring-up retries: each failed connect attempt (the
    ``distributed.connect`` fault point fires inside it) is repeated
    with exponential backoff and jitter, ``retries`` extra times (env
    ``DMLC_RETRY``, default 4) within ``timeout`` seconds (env
    ``DMLC_INIT_TIMEOUT``, default 300), so a worker that comes up
    before its coordinator connects instead of dying."""
    if is_initialized():
        return
    if coordinator is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9876")
        if uri:
            coordinator = f"{uri}:{port}"
    if num_processes is None:
        n = os.environ.get("DMLC_NUM_WORKER")
        num_processes = int(n) if n else None
    if process_id is None:
        i = os.environ.get("DMLC_WORKER_ID")
        process_id = int(i) if i else (0 if num_processes else None)
    if num_processes is not None and process_id is not None \
            and not 0 <= process_id < num_processes:
        raise ValueError(
            f"distributed.init: process_id={process_id} is outside "
            f"[0, num_processes={num_processes}) — check DMLC_WORKER_ID "
            f"against DMLC_NUM_WORKER (every worker id must be a unique "
            f"integer below the worker count)")
    if coordinator is None or num_processes is None or num_processes < 1:
        return  # single-process
    if retries is None:
        retries = int(os.environ.get("DMLC_RETRY", "4") or 4)
    if timeout is None:
        timeout = float(os.environ.get("DMLC_INIT_TIMEOUT", "300") or 300)
    host, port = coordinator.rsplit(":", 1)
    if torch.cuda.is_available():
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist = _dist()
    wait = datetime.timedelta(seconds=timeout)

    def _connect():
        _fault.fire("distributed.connect")
        held = _held_store_socket(int(port)) if process_id == 0 else None
        try:
            store = dist.TCPStore(host, int(port), num_processes,
                                  process_id == 0, timeout=wait,
                                  wait_for_workers=True,
                                  master_listen_fd=held)
        except Exception:
            if held is not None:     # let a retry bind the port itself
                try:
                    os.close(held)
                except OSError:
                    pass
            raise
        chosen, cards = _pick_backend(store, process_id, num_processes, dev)
        dist.init_process_group(chosen, store=store, rank=process_id,
                                world_size=num_processes, timeout=wait)
        return store, chosen, cards

    def _on_retry(attempt, delay, exc):
        _logger.warning(
            "distributed.init: connect to %s failed (%s); retry %d/%d in "
            "%.1fs", coordinator, exc, attempt, retries, delay)

    store, chosen, cards = _fault.retry_call(
        _connect, retries=retries, base_delay=backoff_base, max_delay=30.0,
        deadline=timeout, on_retry=_on_retry,
        # a process group that is already up fails identically forever
        giveup=lambda e: "twice" in str(e) or "already" in str(e))
    _state.update(store=store, backend=chosen, device=dev,
                  rank=process_id, world=num_processes)
    global _leave_registered
    if not _leave_registered:
        atexit.register(_leave_at_exit)
        _leave_registered = True
    _logger.info("distributed.init: rank %d/%d on %s over %s (cards %s)",
                 process_id, num_processes, dev, chosen, cards)
    from . import random as _random
    _random._refold()


def _leave_at_exit():
    """``shutdown()`` at interpreter exit (a no-op if already left)."""
    try:
        shutdown()
    except Exception:   # noqa: BLE001 — exiting anyway; never mask it
        _logger.warning("distributed: leaving the group at exit failed",
                        exc_info=True)


def shutdown():
    """Leave the process group so a later ``init()`` can rebuild it.
    Idempotent; the state resets even when the teardown raises."""
    global _epoch
    if not is_initialized():
        return
    try:
        try:
            barrier("mxtpu-pre-shutdown", timeout=5)
        except Exception:   # noqa: BLE001 — a peer is already gone
            pass
        _dist().destroy_process_group()
    finally:
        _state.update(store=None, backend=None, device=None, rank=0,
                      world=1)
        _epoch += 1
        _barrier_seq.clear()
        from . import random as _random
        _random._refold()


def rank():
    """This process's worker id (ref: KVStore::get_rank)."""
    return _state["rank"]


def num_workers():
    """ref: KVStore::get_group_size."""
    return _state["world"]


def backend():
    """``"nccl"``, ``"gloo"``, or None outside a process group."""
    return _state["backend"]


def device():
    """The rank's device: its card (``r % device_count``), the CPU in a
    gloo run without cards, or the current card outside a group."""
    if _state["device"] is not None:
        return _state["device"]
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name="barrier", timeout=None):
    """ref: KVStore::Barrier.

    Without ``timeout`` every rank waits for the others through a
    collective on the group's devices.  With ``timeout`` (seconds) the
    wait is bounded and rides the store (no backend collective): on
    expiry a ``TimeoutError`` naming the barrier raises, so a supervised
    worker fails fast into the gang-restart path instead of hanging.
    All ranks must reach the same barriers in the same order."""
    if not is_initialized():
        if timeout is not None \
                and int(os.environ.get("DMLC_NUM_WORKER", "0") or 0) > 1:
            raise RuntimeError(
                f"barrier {name!r}: no process group is connected in a "
                f"{os.environ['DMLC_NUM_WORKER']}-worker gang — called "
                f"between shutdown() and init()?")
        return
    if timeout is None:
        t = torch.ones(1, device=_wire_device(_state["device"]))
        _dist().all_reduce(t)
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        return
    store, n = _state["store"], _state["world"]
    seq = _barrier_seq.get(name, 0)
    _barrier_seq[name] = seq + 1
    key = f"mxtpu:{_epoch}:{name}:{seq}"
    store.add(key, 1)
    deadline = time.monotonic() + float(timeout)
    while int(store.add(key, 0)) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"barrier {name!r} timed out after {timeout}s: a peer "
                f"never arrived (dead or hung worker) — failing fast so "
                f"the supervisor can tear the gang down and restart "
                f"from the last snapshot")
        time.sleep(0.005)


# ----------------------------------------------------------- collectives --
def _wire_device(dev):
    """Where a collective's tensors must lie: the rank's card over NCCL,
    the host over gloo."""
    if _state["backend"] == "nccl":
        return _state["device"]
    return torch.device("cpu")


# (dtype, slot) -> a pinned host buffer, reused; one set a thread
_staging = threading.local()


def _host_slot(shape, dtype, slot):
    """A pinned host tensor of ``shape`` through which gloo stages a
    card's tensor: one buffer a dtype and slot, grown as needed and
    reused (a collective returns only when its copies are done, so the
    next one finds the buffer free).  The buffers are the calling
    thread's: two threads' collectives over their own groups (a tensor-
    parallel server's decode loop and its prefill worker) never share
    one."""
    bufs = getattr(_staging, "bufs", None)
    if bufs is None:
        bufs = _staging.bufs = {}
    n = math.prod(shape)
    buf = bufs.get((dtype, slot))
    if buf is None or buf.numel() < n:
        buf = bufs[(dtype, slot)] = torch.empty(
            n, dtype=dtype, pin_memory=True)
    return buf[:n].view(tuple(shape))


def _on_wire(t, slot="in"):
    """``t`` on the backend's device (a copy when it lies elsewhere; a
    card's tensor over gloo goes through the pinned buffer ``slot``)."""
    wire = _wire_device(t.device)
    if t.device == wire:
        return t
    if t.is_cuda:
        h = _host_slot(t.shape, t.dtype, slot)
        h.copy_(t)
        return h
    return t.to(wire)


def _wire_empty(t, shape, slot):
    """An output buffer of ``shape`` on the wire for ``t``'s collective."""
    wire = _wire_device(t.device)
    if wire.type == "cpu" and t.is_cuda:
        return _host_slot(shape, t.dtype, slot)
    return torch.empty(tuple(shape), dtype=t.dtype, device=wire)


def all_reduce_(t, group=None, op="sum"):
    """Sum (or max) ``t`` over the ranks of ``group`` (None: the world),
    in place; returns ``t``.  A no-op outside a process group."""
    if not is_initialized():
        return t
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    w = _on_wire(t)
    dist.all_reduce(w, op=red, group=group)
    if w is not t:
        t.copy_(w)
    return t


def all_gather_into(t, group=None):
    """``(n, *t.shape)``: every rank's ``t`` stacked in rank order, over
    the wire in ``t``'s own dtype."""
    if not is_initialized():
        return t.unsqueeze(0).clone()
    dist = _dist()
    n = dist.get_world_size(group)
    w = _on_wire(t.contiguous())
    out = _wire_empty(t, (n,) + tuple(t.shape), "out")
    if _state["backend"] == "nccl":
        dist.all_gather_into_tensor(out, w, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), w, group=group)
    return out.to(t.device)


def all_to_all(t, group=None):
    """``t`` of shape ``(n, ...)``: row j goes to rank j; returns the
    ``(n, ...)`` rows every rank sent to this one, in rank order
    (``all_to_all_single``, which gloo has too: torch 2.11 and 2.13)."""
    if not is_initialized():
        return t.clone()
    dist = _dist()
    w = _on_wire(t.contiguous())
    out = _wire_empty(t, w.shape, "out")
    dist.all_to_all_single(out, w, group=group)
    return out.to(t.device)


def send_recv(sends, recvs, group=None):
    """Point to point: each ``(tensor, peer)`` of ``sends`` goes to rank
    ``peer`` of ``group`` and each ``(buffer, peer)`` of ``recvs`` is
    filled from ``peer``, all posted together (``batch_isend_irecv``),
    so a ring's sends and receives cannot wait on each other."""
    dist = _dist()
    world = group is None or group is dist.group.WORLD

    def glob(r):
        return r if world else dist.get_global_rank(group, r)
    wires = [(b if b.device == _wire_device(b.device)
              else _wire_empty(b, b.shape, f"recv{i}"), b)
             for i, (b, _) in enumerate(recvs)]
    ops = [dist.P2POp(dist.isend, _on_wire(t, f"send{i}"), glob(p), group)
           for i, (t, p) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, w, glob(p), group)
            for (w, _), (_, p) in zip(wires, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for w, b in wires:
        if w is not b:
            b.copy_(w)


def broadcast_(t, root=0, group=None):
    """``root``'s ``t`` into every rank's ``t``, in place."""
    if not is_initialized():
        return t
    dist = _dist()
    w = _on_wire(t)
    src = root if group is None or group is dist.group.WORLD \
        else dist.get_global_rank(group, root)
    dist.broadcast(w, src=src, group=group)
    if w is not t:
        t.copy_(w)
    return t


def _as_tensor(array):
    if isinstance(array, torch.Tensor):
        return array
    data = getattr(array, "_data", None)        # an NDArray's tensor
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(np.asarray(array)))


def all_sum(array):
    """Sum a process-local array across every worker (the dist kvstore
    merge).  numpy array, tensor or NDArray in; a tensor out, where the
    input lay (a CPU tensor for numpy)."""
    t = _as_tensor(array)
    return all_reduce_(t.clone(), op="sum")


def all_gather(array):
    """Each process's local array stacked along a new leading axis:
    ``(num_workers, *shape)`` on every process (the compressed-gradient
    wire)."""
    return all_gather_into(_as_tensor(array))


def broadcast(array, root=0):
    """``root``'s value on every process (ref: CommDevice::Broadcast
    after the server update)."""
    return broadcast_(_as_tensor(array).clone(), root=root)
