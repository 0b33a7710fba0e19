"""Device contexts for the PyTorch/CUDA port (the port of
``mxnet_tpu/context.py``).

A ``Context`` names a device, ``'gpu'`` (a CUDA card) or ``'cpu'``, and
is a scope: ``with mx.cpu():`` makes the host the default context of
the code inside it.  Every entry point of the port takes a ``device``
(or, in the Gluon and ``nd`` API, ``ctx``) argument whose default is
the current context, which outside any scope is the card.  Without a
card, and without a ``cpu`` context asked for, it raises: it never
carries on silently on the host (the JAX package's ``current_context``
falls back to the CPU; the port does not).

``cpu_pinned`` names the host's page-locked memory (``storage`` hands
out pinned buffers for it); arrays made under it are host tensors.
``shape_trace()`` is the scope in which ``symbol``'s shape inference
traces a graph on ``meta`` tensors: the registry's creation ops make
meta tensors inside it, whatever context they are given.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["Context", "resolve_device", "cpu", "cpu_pinned", "gpu",
           "current_context", "num_gpus", "gpu_memory_info", "shape_trace",
           "tracing_shapes"]

_tls = threading.local()


def _card(device, index):
    """The CUDA device ``index`` (None: the current one); raises without
    a card.  On the card path float32 matrix products are pinned to full
    float32 (no TF32), matching the JAX reference's float32 arithmetic."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            f"— pass device='cpu' (ctx=mx.cpu()) to run the plain PyTorch "
            f"path")
    if index is None:
        index = torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r}: only "
                           f"{torch.cuda.device_count()} CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", index)


class Context:
    """A device, ``Context('gpu', i)`` or ``Context('cpu')``; also a
    scope that makes it the default context.  A ``gpu`` context checks
    for the card when it is made.  It compares equal to the
    ``torch.device`` it names."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        elif isinstance(device_type, torch.device):
            device_type, device_id = ("gpu" if device_type.type == "cuda"
                                      else "cpu", device_type.index or 0)
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}: the "
                             f"port runs on 'gpu' or, when asked, 'cpu' "
                             f"('cpu_pinned')")
        self.device_type = device_type
        self.device_id = int(device_id)
        self.device = (_card(f"gpu({self.device_id})", self.device_id)
                       if device_type == "gpu" else torch.device("cpu"))

    def __eq__(self, other):
        if isinstance(other, torch.device):
            return self.device == other
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()

    def empty_cache(self):
        """Return the card's cached, unused blocks to the driver."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def memory_info(self):
        """The allocator's statistics of this device
        (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
        ``reserved_bytes.all.peak``, ...; none on the host), and the
        framework's own: ``framework_live_bytes`` and
        ``framework_peak_bytes``, the bytes of this device's NDArrays
        (``storage``'s accounting)."""
        from . import storage
        out = dict(torch.cuda.memory_stats(self.device)) \
            if self.device.type == "cuda" else {}
        st = storage.stats(str(self))
        out["framework_live_bytes"] = st["live_bytes"]
        out["framework_peak_bytes"] = st["peak_bytes"]
        return out

    @classmethod
    def default_ctx(cls):
        return current_context()


def cpu(device_id=0) -> Context:
    """The host (``device_id`` is accepted for API parity)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0) -> Context:
    """The host's page-locked memory (``device_id`` is accepted for API
    parity)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0) -> Context:
    """CUDA card ``device_id``; raises when there is none."""
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope's context, else the current
    CUDA card (raises without one)."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", _card("gpu", None).index)


_DEVICE_CTX = {}


def context_of(device: torch.device) -> Context:
    """The ``Context`` of a tensor's device (memoised: NDArray asks for
    it on every ``.context``)."""
    ctx = _DEVICE_CTX.get(device)
    if ctx is None:
        ctx = _DEVICE_CTX[device] = Context(device)
    return ctx


@contextlib.contextmanager
def shape_trace():
    """Inside, on this thread, the registry's creation ops make ``meta``
    tensors: shape inference traces a graph on tensors that hold no
    data, the port's counterpart of ``jax.eval_shape``."""
    depth = getattr(_tls, "meta", 0)
    _tls.meta = depth + 1
    try:
        yield
    finally:
        _tls.meta = depth


def tracing_shapes() -> bool:
    """True inside ``shape_trace`` on this thread."""
    return getattr(_tls, "meta", 0) > 0


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id=0):
    """``(free, total)`` bytes of CUDA card ``device_id``."""
    return torch.cuda.mem_get_info(gpu(device_id).device)


def resolve_device(device="cuda"):
    """A ``torch.device`` from ``"cuda"``/``"cuda:i"``/``"cpu"``, a
    ``torch.device``, a ``Context``, or None (the current context).  A
    CUDA device needs a card: without one this raises ``RuntimeError``."""
    if device is None:
        return current_context().device
    if isinstance(device, Context):
        return device.device
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: the port runs on 'cuda' "
                         f"or, when asked, 'cpu'")
    return _card(device, dev.index)
