"""Device resolution for the PyTorch/CUDA port.

Every entry point of the port takes a ``device`` (or, in the Gluon API,
``ctx``) argument whose default is the card.  It runs on the card unless
the caller asks for the CPU; when no card is present and the caller did
not ask for ``"cpu"``, it raises — it never carries on silently on the
host.  ``cpu()``/``gpu(i)``/``current_context()`` are the JAX package's
context names; a context here is a ``torch.device``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "cpu", "gpu", "current_context"]


def resolve_device(device="cuda"):
    """``"cuda"``/``"cuda:i"``/``"cpu"``/``torch.device`` → a
    ``torch.device``.  A CUDA device needs a card: without one this
    raises ``RuntimeError``.  On the card path float32 matrix products
    are pinned to full float32 (no TF32), matching the JAX reference's
    float32 arithmetic."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: the port runs on 'cuda' "
                         f"or, when asked, 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            f"— pass device='cpu' to run the plain PyTorch path")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r}: only "
                           f"{torch.cuda.device_count()} CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev



def cpu(device_id=0):
    """The host (``device_id`` is accepted for API parity)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA card ``device_id``; raises when there is none."""
    return resolve_device(f"cuda:{int(device_id)}")


def current_context():
    """The default context: the current CUDA card (raises without one)."""
    return resolve_device("cuda")
