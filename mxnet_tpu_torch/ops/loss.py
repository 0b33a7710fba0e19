"""Loss ops (the port of ``mxnet_tpu/ops/loss.py``)."""
from __future__ import annotations

import torch

from .matrix import pick
from .registry import register_op

__all__ = ["softmax_cross_entropy"]


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Cross entropy of ``softmax(data)`` against integer labels, summed
    over the batch."""
    return -pick(torch.log_softmax(data, dim=-1), label, axis=-1).sum()


@register_op("LinearRegressionOutput", aliases=("linear_regression_output",))
def _linear_regression_output(data, label=None, grad_scale=1.0):
    """The forward is the identity; the L2 gradient is the implicit loss
    of a symbolic executor (under autograd use ``gluon.loss.L2Loss``)."""
    return data


@register_op("MAERegressionOutput", aliases=("mae_regression_output",))
def _mae_regression_output(data, label=None, grad_scale=1.0):
    """The identity forward of the L1 regression head."""
    return data


@register_op("LogisticRegressionOutput",
             aliases=("logistic_regression_output",))
def _logistic_regression_output(data, label=None, grad_scale=1.0):
    """The sigmoid forward of the logistic regression head."""
    return torch.sigmoid(data)


@register_op("CTCLoss", aliases=("ctc_loss",))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """CTC loss per sequence.  ``data`` (T, N, C) unnormalised, ``label``
    (N, L) integer; returns (N,).  Without ``use_label_lengths`` a
    label's length is its count of entries > 0 (blank first) or L
    (blank last)."""
    t_max, n, c = data.shape
    logp = torch.log_softmax(data.float(), dim=-1)
    labels = label.long()
    blank = 0 if blank_label == "first" else c - 1
    if data_lengths is None or not use_data_lengths:
        data_lengths = torch.full((n,), t_max, dtype=torch.long,
                                  device=data.device)
    if label_lengths is None or not use_label_lengths:
        label_lengths = (labels > 0).sum(dim=1) if blank_label == "first" \
            else torch.full((n,), labels.shape[1], dtype=torch.long,
                            device=data.device)
    return torch.nn.functional.ctc_loss(
        logp, labels, data_lengths.long(), label_lengths.long(),
        blank=blank, reduction="none")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward replaces the incoming gradient
    with ``scale`` (the reference's MakeLoss)."""

    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.broadcast_to(ctx.scale.to(g.dtype), g.shape), None


@register_op("make_loss", aliases=("MakeLoss",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0,
               normalization="null"):
    """Mark an output as a loss head: identity forward, and a backward
    that writes ``grad_scale`` (per batch, or per valid entry, with
    ``normalization``) whatever gradient arrives."""
    scale = torch.full((), grad_scale, dtype=torch.float32,
                       device=data.device)
    if normalization == "batch":
        scale = scale / data.shape[0]
    elif normalization == "valid":
        scale = scale / torch.clamp_min(
            (data > valid_thresh).float().sum(), 1.0)
    return _MakeLoss.apply(data, scale)
