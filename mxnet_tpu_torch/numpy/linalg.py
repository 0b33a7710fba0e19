"""``mx.np.linalg`` (the port of ``mxnet_tpu/numpy/linalg.py``; ref:
python/mxnet/numpy/linalg.py) on ``torch.linalg``, with numpy's
signatures and results: ``lstsq`` gives ``(x, residuals, rank, s)`` on
any device (through the SVD, as the card's ``torch.linalg.lstsq`` has
no rank), ``matrix_rank`` an int32."""
from __future__ import annotations

import sys

import numpy as np
import torch

_FNS = ["norm", "svd", "cholesky", "inv", "pinv", "det", "slogdet",
        "eigh", "eigvalsh", "qr", "solve", "lstsq", "matrix_rank",
        "matrix_power", "tensorsolve", "tensorinv", "multi_dot"]


def _norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    if not compute_uv:
        return torch.linalg.svdvals(a)
    return tuple(torch.linalg.svd(a, full_matrices=full_matrices))


def _cholesky(a, *, upper=False):
    return torch.linalg.cholesky(a, upper=upper)


def _pinv(a, rcond=None, hermitian=False, *, rtol=None):
    return torch.linalg.pinv(a, rtol=rtol if rtol is not None else rcond,
                             hermitian=hermitian)


def _slogdet(a, *, method=None):
    return tuple(torch.linalg.slogdet(a))


def _eigh(a, UPLO="L", symmetrize_input=True):
    return tuple(torch.linalg.eigh(a, UPLO=UPLO))


def _eigvalsh(a, UPLO="L"):
    return torch.linalg.eigvalsh(a, UPLO=UPLO)


def _qr(a, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(a, mode="r")[1]
    return tuple(torch.linalg.qr(a, mode=mode))


def _lstsq(a, b, rcond=None, *, numpy_resid=False):
    s = torch.linalg.svdvals(a)
    m, n = a.shape[-2], a.shape[-1]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    rank = (s > rcond * s.max()).sum()
    x = torch.linalg.pinv(a, rtol=rcond) @ b
    r = b - a @ x
    resid = (r * r).sum(0).reshape(-1)
    if not (int(rank) == n and m > n):
        resid = resid[:0]
    return x, resid, rank.to(torch.int32), s


def _matrix_rank(M, rtol=None, *, tol=None):
    if M.dim() < 2:
        return (M != 0).any().to(torch.int32)
    return torch.linalg.matrix_rank(M, rtol=rtol, atol=tol).to(torch.int32)


def _tensorsolve(a, b, axes=None):
    return torch.linalg.tensorsolve(a, b, dims=axes)


def _tensorinv(a, ind=2):
    return torch.linalg.tensorinv(a, ind=ind)


def _multi_dot(arrays, *, precision=None):
    return torch.linalg.multi_dot(list(arrays))


_IMPL = {
    "norm": _norm, "svd": _svd, "cholesky": _cholesky,
    "inv": torch.linalg.inv, "pinv": _pinv, "det": torch.linalg.det,
    "slogdet": _slogdet, "eigh": _eigh, "eigvalsh": _eigvalsh, "qr": _qr,
    "solve": torch.linalg.solve, "lstsq": _lstsq,
    "matrix_rank": _matrix_rank, "matrix_power": torch.linalg.matrix_power,
    "tensorsolve": _tensorsolve, "tensorinv": _tensorinv,
    "multi_dot": _multi_dot,
}

_this = sys.modules[__name__]


def _is_array(a):
    from ..ndarray.ndarray import NDArray
    return isinstance(a, (NDArray, torch.Tensor, np.ndarray, list))


def _on_floats(name, body):
    """``body`` with its array arguments as floating tensors."""
    from . import _float, _t

    def call(*args, **kwargs):
        args = [[_float(_t(x)) for x in a] if name == "multi_dot"
                else _float(_t(a)) if _is_array(a) else a for a in args]
        return body(*args, **kwargs)
    return call


from . import _dispatch  # noqa: E402

for _n in _FNS:
    setattr(_this, _n, _dispatch(_n, _on_floats(_n, _IMPL[_n])))

__all__ = list(_FNS)
