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
        for gen in _state["gens"].values():
            gen.manual_seed(_state["seed"])
        start = _first_draw(_state["seed"])
        for ctr in _state["counters"].values():
            ctr.fill_(start)
    _initializer.seed(seed_state)


def generator(device="cpu"):
    """The seeded ``torch.Generator`` of ``device`` (made at first use)."""
    dev = _device(device)
    with _lock:
        gen = _state["gens"].get(dev)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(_state["seed"])
            _state["gens"][dev] = gen
        return gen


def cuda_generators(device):
    """The generators of CUDA ``device`` made so far (what a CUDA graph
    captured on it registers)."""
    dev = _device(device)
    with _lock:
        return [g for d, g in _state["gens"].items() if d == dev]


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
            ctr = torch.full((), _first_draw(_state["seed"]),
                             dtype=torch.int64, device=dev)
            _state["counters"][dev] = ctr
    out = ctr.to(torch.int32)       # wraps mod 2**32, as an int32
    ctr.add_(_SEED_STEP)
    return out
