"""The framework's random stream (the port of ``mxnet_tpu/random.py``).

One seeded ``torch.Generator`` per device: ``generator(device)`` is the
stream that dropout draws its masks from on that device, and
``next_seed()`` draws an int32 seed from the host's stream (a host draw:
no device sync).  ``seed(s)`` restarts every stream from ``s`` and
reseeds the initializers' generator too, as ``mx.random.seed`` reseeds
the one key the JAX package's initializers and ops all split from.

Flash attention takes its dropout seed from device memory:
``next_seed_tensor(device)`` returns a fresh 0-d int32 tensor holding
the device's seed counter and then advances the counter — two device
ops, no host sync.  A captured CUDA graph that contains the call
advances the counter on every replay, so each replay draws new masks,
and eager and captured runs from the same ``seed(s)`` draw the same
seeds: the counter starts at the first value ``next_seed()`` gives after
``seed(s)`` and steps by a fixed odd constant (mod 2**32).

``seed(s)`` reseeds the existing generators and counters in place, so a
graph that holds them (``cuda_generators`` lists the ones a capture
registers) stays valid.

In a process group (``distributed.init``) rank r > 0 folds its rank into
the device streams and the seed counters, so each rank draws its own
dropout masks and rounding noise from the same ``seed(s)``, as the JAX
step folds ``axis_index`` into its key; the initializers' generator is
not folded, so every rank initializes the same parameters.  Rank 0's
streams are those of a run of one process.  ``generator(device,
salt)`` is a further stream of the device (the gradient quantizer's
rounding: ``salt`` decorrelates it from dropout's).

The JAX package splits threefry keys, so the same seed gives other
numbers here; the port does not reproduce JAX's key stream bit for bit.
Parity with dropout on is held where the draw is explicit: the
flash-attention kernels take the seed as an argument and hash it as the
JAX kernels do (``ops.flash_attention.uniform01``), so the same seed
gives the same masks.
"""
from __future__ import annotations

import threading

import torch

from . import initializer as _initializer

__all__ = ["seed", "generator", "next_seed", "next_seed_tensor",
           "cuda_generators"]

# the seed counter's step: odd, so 2**32 calls pass before a seed repeats
_SEED_STEP = 0x9E3779B9

_lock = threading.Lock()
_state = {"seed": 0, "gens": {}, "counters": {}}


def _first_draw(seed_state):
    """The first int32 the host stream gives after ``seed(seed_state)``."""
    gen = torch.Generator().manual_seed(int(seed_state))
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))


def _stream_seed(salt=0):
    """The seed of a device stream: the global seed, with this process's
    rank and ``salt`` folded in (rank 0, salt 0: the seed itself)."""
    from . import distributed
    rank = distributed.rank()
    s = _state["seed"]
    if rank == 0 and salt == 0:
        return s
    return (s * 0x9E3779B97F4A7C15 + rank * 0xBF58476D1CE4E5B9
            + salt * 0x94D049BB133111EB) % 2 ** 63


def _reseed_locked():
    for (_dev, salt), gen in _state["gens"].items():
        gen.manual_seed(_stream_seed(salt))
    start = _first_draw(_stream_seed())
    for ctr in _state["counters"].values():
        ctr.fill_(start)


def _refold():
    """Reseed every stream after the process's rank changed (a process
    group joined or left)."""
    with _lock:
        _reseed_locked()


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state, ctx=None):
    """Restart every device's stream (and the initializers') from
    ``seed_state``; ``ctx`` is accepted for API parity."""
    with _lock:
        _state["seed"] = int(seed_state)
        _reseed_locked()
    _initializer.seed(seed_state)


def generator(device="cpu", salt=0):
    """The seeded ``torch.Generator`` of ``device`` (made at first use);
    ``salt`` picks another stream of the same device."""
    dev = _device(device)
    with _lock:
        gen = _state["gens"].get((dev, salt))
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(
                _stream_seed(salt))
            _state["gens"][(dev, salt)] = gen
        return gen


def cuda_generators(device):
    """The generators of CUDA ``device`` made so far (what a CUDA graph
    captured on it registers)."""
    dev = _device(device)
    with _lock:
        return [g for (d, _salt), g in _state["gens"].items() if d == dev]


def next_seed():
    """An int32 in ``[0, 2**31 - 1)`` from the host stream, as the JAX
    flash op draws ``randint(key, (1,), 0, 2**31 - 1)`` per call."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=generator("cpu")))


def next_seed_tensor(device):
    """The next seed of ``device``'s counter as a new 0-d int32 tensor
    on the device; the counter then steps on.  The counter is made at
    first use — before a capture, never inside one."""
    dev = _device(device)
    with _lock:
        ctr = _state["counters"].get(dev)
        if ctr is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "random.next_seed_tensor: the seed counter of "
                    f"{dev} is made inside a CUDA graph capture; run the "
                    "step once before capturing it")
            ctr = torch.full((), _first_draw(_stream_seed()),
                             dtype=torch.int64, device=dev)
            _state["counters"][dev] = ctr
    out = ctr.to(torch.int32)       # wraps mod 2**32, as an int32
    ctr.add_(_SEED_STEP)
    return out
