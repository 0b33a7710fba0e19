"""Unfused recurrent cells (the port of
``mxnet_tpu/gluon/rnn/rnn_cell.py``): ``RecurrentCell`` with
``unroll``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
``ResidualCell`` and ``BidirectionalCell``.

A cell is called as ``cell(inputs, states)`` and returns ``(out,
next_states)``, tensors for tensors and NDArrays for NDArrays.
``unroll`` is the Python loop over time steps; the fused layers
(``rnn_layer.py``) run long sequences in one op.  ``ZoneoutCell`` draws
its masks with ``nd.random.bernoulli`` on the data's device.
"""
from __future__ import annotations

import torch

from ... import autograd as _autograd
from ...ndarray.ndarray import NDArray, _wrap_all
from ...ops.sequence import SequenceMask
from ..block import HybridBlock
from .rnn_layer import _states_of

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


def _seq(inputs, length, layout):
    """The steps of ``inputs`` (a list of ``(N, C)`` or one tensor in
    ``layout``) as tensors, the batch size and whether NDArrays came
    in."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        wrap = isinstance(inputs[0], NDArray)
        seq = [_tensor(x) for x in inputs]
        return seq, seq[0].shape[0], wrap
    x = _tensor(inputs)
    batch = x.shape[0] if axis == 1 else x.shape[1]
    return [x.select(axis, t) for t in range(length)], batch, \
        isinstance(inputs, NDArray)


class RecurrentCell(HybridBlock):
    """A cell of one time step."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for c in self._children.values():
            if hasattr(c, "reset"):
                c.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (NDArrays); ``kwargs`` go to ``nd.zeros``
        (``ctx``, ``dtype``)."""
        from ... import ndarray as nd
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(nd.zeros(info["shape"], **kwargs))
        return states

    def infer_shape(self, *args):
        pass

    def _step_states(self, seq, batch, begin_state):
        if begin_state is not None:
            return [_tensor(s) for s in begin_state]
        return [s._data for s in self.begin_state(batch, ctx=seq[0].device)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps; the outputs as a list of ``(N, C)``, or
        stacked along ``layout``'s time axis with ``merge_outputs``,
        masked past ``valid_length`` when given."""
        self.reset()
        seq, batch, wrap = _seq(inputs, length, layout)
        states = self._step_states(seq, batch, begin_state)
        outputs = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if valid_length is not None:
            m = SequenceMask(torch.stack(outputs), _tensor(valid_length),
                             use_sequence_length=True)
            outputs = list(m.unbind(0))
        if merge_outputs:
            outputs = torch.stack(outputs, dim=layout.find("T"))
        if wrap:
            return _wrap_all(outputs), _wrap_all(list(states))
        return outputs, states

    def __call__(self, inputs, *states):
        self._counter += 1
        return super().__call__(inputs, *_states_of(states))

    def forward(self, inputs, *states):
        return super().forward(inputs, list(states))


class _GatedCell(RecurrentCell):
    """The parameters of a cell with ``gates`` gate blocks."""

    def __init__(self, hidden_size, gates, input_size,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._gates = gates
        self._input_size = input_size
        n = gates * hidden_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(n, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(n, hidden_size),
                                          init=h2h_weight_initializer)
        self.i2h_bias = self.params.get("i2h_bias", shape=(n,),
                                        init=i2h_bias_initializer)
        self.h2h_bias = self.params.get("h2h_bias", shape=(n,),
                                        init=h2h_bias_initializer)

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """``act(W_ih x + b_ih + W_hh h + b_hh)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 1, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM step, gate order ``i, f, g, o`` (the fused op's)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 4, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "NC"},
                {"shape": shape, "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        ig, fg, gg, og = (i2h + h2h).chunk(4, dim=-1)
        c = fg.sigmoid() * states[1] + ig.sigmoid() * gg.tanh()
        h = og.sigmoid() * c.tanh()
        return h, [h, c]


class GRUCell(_GatedCell):
    """GRU step, gate order ``r, z, n`` (the fused op's)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 3, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        i_r, i_z, i_n = i2h.chunk(3, dim=-1)
        h_r, h_z, h_n = h2h.chunk(3, dim=-1)
        r = (i_r + h_r).sigmoid()
        z = (i_z + h_z).sigmoid()
        n = (i_n + r * h_n).tanh()
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        out = []
        for c in self._children.values():
            out.extend(c.state_info(batch_size))
        return out

    def begin_state(self, batch_size=0, **kwargs):
        out = []
        for c in self._children.values():
            out.extend(c.begin_state(batch_size, **kwargs))
        return out

    def __call__(self, inputs, *states):
        self._counter += 1
        states = _states_of(states)
        next_states = []
        p = 0
        for c in self._children.values():
            n = len(c.state_info())
            inputs, st = c(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class ModifierCell(RecurrentCell):
    """A cell that wraps ``base_cell`` and takes its states."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class DropoutCell(RecurrentCell):
    """Dropout on the inputs; no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """In training, each output (and state) element keeps its previous
    value with probability ``zoneout_outputs`` (``zoneout_states``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    @staticmethod
    def _mask(p, like):
        """1 with probability ``1 - p``, in ``like``'s dtype and device."""
        from ... import ndarray as nd
        return nd.random.bernoulli(p=1 - p, shape=like.shape,
                                   ctx=like.device, dtype=like.dtype)._data

    def __call__(self, inputs, *states):
        states = _states_of(states)
        wrap = isinstance(inputs, NDArray)
        out, next_states = self.base_cell(_tensor(inputs),
                                          [_tensor(s) for s in states])
        if _autograd.is_training():
            if self.zoneout_outputs > 0:
                mask = self._mask(self.zoneout_outputs, out)
                prev = self._prev_output if self._prev_output is not None \
                    else torch.zeros_like(out)
                out = mask * out + (1 - mask) * prev
            if self.zoneout_states > 0:
                mixed = []
                for new, old in zip(next_states, states):
                    mask = self._mask(self.zoneout_states, new)
                    mixed.append(mask * new + (1 - mask) * _tensor(old))
                next_states = mixed
        self._prev_output = out
        if wrap:
            return _wrap_all(out), _wrap_all(list(next_states))
        return out, next_states


class ResidualCell(ModifierCell):
    """``base_cell``'s output plus its input."""

    def __call__(self, inputs, *states):
        out, states = self.base_cell(inputs, _states_of(states))
        return out + inputs, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward in time, outputs
    concatenated; ``unroll`` only."""

    def __init__(self, l_cell, r_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self.l_cell.begin_state(batch_size, **kwargs)
                + self.r_cell.begin_state(batch_size, **kwargs))

    def __call__(self, inputs, *states):
        raise NotImplementedError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        seq, batch, wrap = _seq(inputs, length, layout)
        nl = len(self.l_cell.state_info())
        states = [_tensor(s) for s in begin_state] if begin_state else None
        l_out, l_states = self.l_cell.unroll(
            length, seq, states[:nl] if states else None, layout,
            merge_outputs=False, valid_length=valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, seq[::-1], states[nl:] if states else None, layout,
            merge_outputs=False, valid_length=valid_length)
        outs = [torch.cat([lo, ro], dim=-1)
                for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outs = torch.stack(outs, dim=layout.find("T"))
        states = list(l_states) + list(r_states)
        if wrap:
            return _wrap_all(outs), _wrap_all(states)
        return outs, states
