"""The framework's random stream (the port of ``mxnet_tpu/random.py``).

One seeded ``torch.Generator`` per device: ``generator(device)`` is the
stream that dropout draws its masks from on that device, and
``next_seed()`` draws the int32 seed of one flash-attention call from
the host's stream (a host draw: no device sync).  ``seed(s)`` restarts
every stream from ``s`` and reseeds the initializers' generator too, as
``mx.random.seed`` reseeds the one key the JAX package's initializers
and ops all split from.

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

__all__ = ["seed", "generator", "next_seed"]

_lock = threading.Lock()
_state = {"seed": 0, "gens": {}}


def seed(seed_state, ctx=None):
    """Restart every device's stream (and the initializers') from
    ``seed_state``; ``ctx`` is accepted for API parity."""
    with _lock:
        _state["seed"] = int(seed_state)
        _state["gens"] = {}
    _initializer.seed(seed_state)


def generator(device="cpu"):
    """The seeded ``torch.Generator`` of ``device`` (made at first use)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["gens"].get(dev)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(_state["seed"])
            _state["gens"][dev] = gen
        return gen


def next_seed():
    """An int32 in ``[0, 2**31 - 1)`` from the host stream, as the JAX
    flash op draws ``randint(key, (1,), 0, 2**31 - 1)`` per call."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=generator("cpu")))
