"""The fused RNN op (the port of ``mxnet_tpu/ops/rnn.py``): LSTM, GRU
and the vanilla ReLU/tanh RNN over one packed parameter vector.

The packed layout is the JAX package's (and cuDNN's reference packing):
every ``w_ih``/``w_hh`` pair layer-major, direction within layer, then
every ``b_ih``/``b_hh`` pair in the same order.  Gate order: LSTM
``[i, f, g, o]``, GRU ``[r, z, n]`` with ``r`` applied to
``W_hn h + b_hn``.  Data is time-major ``(T, N, C)``.

Each (layer, direction) is one ``torch._VF.{lstm,gru,rnn_tanh,
rnn_relu}`` call with one layer and no dropout, on views of the packed
vector (so the gradient lands in it), for float32 and bfloat16 alike:
on the card torch dispatches both dtypes to cuDNN's RNN (its
``elemWiseRNNcell`` and ``LSTM_elementWise_bp1`` kernels between
per-step GEMMs; float32 GEMMs in TF32 while
``torch.backends.cudnn.allow_tf32`` is on, which the port turns off
once it resolves the card, ``context._card``), on the CPU to ATen's
per-step loop.  The reverse direction runs the flipped sequence, as the
JAX op scans it.  The views are not cuDNN's flat buffer, so cuDNN
compacts them into one at every call (a device-to-device copy of the
layer's weights); its warning about that is silenced around the call
only.

Dropout between layers (``p > 0``, training, not after the last layer)
draws its mask from the port's generator of the data's device
(``ops.nn.Dropout``), never from cuDNN's dropout state, so a captured
graph draws a fresh mask on every replay; the draws are torch's, not
the JAX package's threefry.

``rnn_reference`` is the plain per-time-step version of the JAX cells
(no dropout): the yardstick the op is held against on the card.
"""
from __future__ import annotations

import warnings

import torch

from .. import autograd as _autograd
from .nn import Dropout
from .registry import register_op

__all__ = ["rnn_param_size", "rnn_reference", "RNN"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
# raised by cuDNN's RNN for weights outside one flat buffer
_COMPACT_WARNING = "RNN module weights are not part of single contiguous"


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional,
                   projection_size=None):
    """Total packed parameter count."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (in_sz + state_size + 2)
    return size


def _unpack(params, mode, input_size, state_size, num_layers, dirs):
    """Views ``(w_ih, w_hh, b_ih, b_hh)`` of the packed vector, indexed
    ``[layer * dirs + dir]``."""
    g, h = _GATES[mode], state_size
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * dirs
        shapes += [(g * h, in_sz), (g * h, h)] * dirs
    shapes += [(g * h,), (g * h,)] * (num_layers * dirs)
    out, off = [], 0
    for shp in shapes:
        n = 1
        for s in shp:
            n *= s
        out.append(params[off:off + n].view(shp))
        off += n
    k = 2 * num_layers * dirs
    weights, biases = out[:k], out[k:]
    return [(weights[2 * i], weights[2 * i + 1], biases[2 * i],
             biases[2 * i + 1]) for i in range(num_layers * dirs)]


def _run_direction(x, h0, c0, cell, mode, reverse):
    """One layer in one direction through ``torch._VF``; ``h0``/``c0``
    are ``(1, N, H)``.  Returns ``(ys, h_n, c_n or None)``, the states
    ``(1, N, H)``."""
    xs = torch.flip(x, (0,)) if reverse else x
    fn = getattr(torch._VF, mode)        # lstm, gru, rnn_tanh, rnn_relu
    train = torch.is_grad_enabled()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_COMPACT_WARNING)
        if mode == "lstm":
            ys, h_n, c_n = fn(xs, (h0, c0), list(cell), True, 1, 0.0, train,
                              False, False)
        else:
            ys, h_n = fn(xs, h0, list(cell), True, 1, 0.0, train, False,
                         False)
            c_n = None
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys, h_n, c_n


def _zero_states(data, mode, state, state_cell, rows, h):
    shape = (rows, data.shape[1], h)
    if state is None:
        state = data.new_zeros(shape)
    if state_cell is None and mode == "lstm":
        state_cell = data.new_zeros(shape)
    return state, state_cell


@register_op("RNN", needs_rng=True)
def RNN(data, parameters, state=None, state_cell=None, state_size=None,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, training=None):
    """Fused multi-layer RNN.  ``data (T, N, C)``; ``state (L*dirs, N,
    H)``, and for an LSTM ``state_cell``; omitted states are zeros.
    Returns ``(out, h_n[, c_n])``, always the tuple.  The clip applies
    to the returned ``c_n`` only; ``projection_size`` and
    ``use_sequence_length`` are accepted and ignored, as in the JAX
    op."""
    if training is None:
        training = _autograd.is_training()
    dirs = 2 if bidirectional else 1
    h = state_size
    state, state_cell = _zero_states(data, mode, state, state_cell,
                                     num_layers * dirs, h)
    cells = _unpack(parameters, mode, data.shape[-1], h, num_layers, dirs)
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            c0 = state_cell[idx:idx + 1] if mode == "lstm" else None
            ys, h_n, c_n = _run_direction(x, state[idx:idx + 1], c0,
                                          cells[idx], mode, d == 1)
            outs.append(ys)
            h_states.append(h_n)
            if mode == "lstm":
                c_states.append(c_n)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0 and training and layer < num_layers - 1:
            x = Dropout(x, p=p, training=True)
    h_out = torch.cat(h_states, dim=0)
    if mode != "lstm":
        return x, h_out
    c_out = torch.cat(c_states, dim=0)
    if lstm_state_clip_min is not None and lstm_state_clip_max is not None:
        c_out = torch.clamp(c_out, lstm_state_clip_min, lstm_state_clip_max)
    return x, h_out, c_out


# ------------------------------------------------------- the plain version --
def _cell_step(mode, x_t, h, c, w_ih, w_hh, b_ih, b_hh):
    """One time step of the JAX package's cells."""
    if mode == "lstm":
        gates = x_t @ w_ih.T + b_ih + b_hh + h @ w_hh.T
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        i_r, i_z, i_n = (x_t @ w_ih.T + b_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1 - z) * n + z * h, None
    pre = x_t @ w_ih.T + b_ih + b_hh + h @ w_hh.T
    return (torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)), None


def rnn_reference(data, parameters, state=None, state_cell=None,
                  state_size=None, num_layers=1, bidirectional=False,
                  mode="lstm", lstm_state_clip_min=None,
                  lstm_state_clip_max=None):
    """``RNN`` without dropout as a Python loop over time steps of the
    JAX package's cells (``mxnet_tpu/ops/rnn.py`` ``_lstm_cell``,
    ``_gru_cell``, ``_vanilla_cell``): the plain version."""
    dirs = 2 if bidirectional else 1
    h = state_size
    state, state_cell = _zero_states(data, mode, state, state_cell,
                                     num_layers * dirs, h)
    cells = _unpack(parameters, mode, data.shape[-1], h, num_layers, dirs)
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            hs, cs = state[idx], state_cell[idx] if mode == "lstm" else None
            steps = range(x.shape[0] - 1, -1, -1) if d == 1 \
                else range(x.shape[0])
            ys = [None] * x.shape[0]
            for t in steps:
                hs, cs = _cell_step(mode, x[t], hs, cs, *cells[idx])
                ys[t] = hs
            outs.append(torch.stack(ys))
            h_states.append(hs)
            c_states.append(cs)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
    h_out = torch.stack(h_states)
    if mode != "lstm":
        return x, h_out
    c_out = torch.stack(c_states)
    if lstm_state_clip_min is not None and lstm_state_clip_max is not None:
        c_out = torch.clamp(c_out, lstm_state_clip_min, lstm_state_clip_max)
    return x, h_out, c_out
