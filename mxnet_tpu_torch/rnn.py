"""`mx.rnn` — the legacy symbolic RNN cell API (the port of
``mxnet_tpu/rnn.py``).

ref: python/mxnet/rnn/rnn_cell.py — RNNCell/LSTMCell/GRUCell compose
per-step symbol subgraphs; ``unroll`` lays out the recurrence as an
explicit graph that the executor runs.  The unroll IS the program: on
the card the bound executor captures the static unroll as one CUDA
graph, like the reference's bucketed executors, and ``FusedRNNCell``
maps onto the port's fused ``RNN`` op (cuDNN's RNN on the card,
ops/rnn.py).  Parameter variables carry
MXNet's naming (``{prefix}i2h_weight`` ...) so BucketingModule's shared
arrays line up across buckets, and ``begin_state`` defaults to
batch-shaped zeros built with ``zeros_like`` (no static batch size
needed at composition time).

Gate orders match ops/rnn.py (= the reference): LSTM [i, f, c, o];
GRU [r, z, n].
"""
from __future__ import annotations

from typing import List, Optional

from . import symbol as sym
from .ops.rnn import rnn_param_size

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "FusedRNNCell"]


def _split_inputs(inputs, length, layout):
    """NTC/TNC symbol -> list of T per-step (N, C) symbols."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    axis = layout.find("T")
    steps = sym.SliceChannel(inputs, num_outputs=length, axis=axis,
                             squeeze_axis=True)
    return [steps[i] for i in range(length)]


def _merge_outputs(outputs, layout):
    axis = layout.find("T")
    expanded = [sym.expand_dims(o, axis=axis) for o in outputs]
    return sym.Concat(*expanded, dim=axis)


class BaseRNNCell:
    """ref: rnn_cell.BaseRNNCell."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._counter = 0

    #: how many entries of a FLAT state list this cell consumes/produces
    #: (ref: BaseRNNCell.state_info length) — the 1.x API passes flat
    #: state lists through stacks, never nested ones
    num_states = 1

    def reset(self):
        self._counter = 0

    def begin_state(self):
        """Zero initial states.  States default to
        batch-shaped zeros INSIDE the first step (``zeros_like`` on a gate
        pre-activation keeps the batch dim symbolic), so ``None`` is the
        canonical zero state — this returns it explicitly for API parity
        with the reference's ``cell.begin_state()``."""
        return None

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """ref: BaseRNNCell.unroll — lay the recurrence out as a graph."""
        self.reset()
        steps = _split_inputs(inputs, length, layout)
        states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
        if merge_outputs:
            return _merge_outputs(outputs, layout), states
        return outputs, states


class _GatedCell(BaseRNNCell):
    """Shared i2h/h2h parameterisation (ref: rnn_cell.RNNCell params)."""

    def __init__(self, num_hidden, prefix, n_gates):
        super().__init__(prefix)
        self._h = num_hidden
        self._g = n_gates
        p = self._prefix
        self.i2h_weight = sym.Variable(f"{p}i2h_weight")
        self.i2h_bias = sym.Variable(f"{p}i2h_bias")
        self.h2h_weight = sym.Variable(f"{p}h2h_weight")
        self.h2h_bias = sym.Variable(f"{p}h2h_bias")

    def _i2h(self, x, name_t):
        return sym.FullyConnected(x, weight=self.i2h_weight,
                                  bias=self.i2h_bias,
                                  num_hidden=self._g * self._h,
                                  name=f"{self._prefix}i2h_t{name_t}")

    def _h2h(self, h, name_t):
        return sym.FullyConnected(h, weight=self.h2h_weight,
                                  bias=self.h2h_bias,
                                  num_hidden=self._g * self._h,
                                  name=f"{self._prefix}h2h_t{name_t}")

    def _zero_state_like(self, i2h_out):
        """(N, H) zeros with the batch dim taken from a gate pre-act."""
        return sym.zeros_like(
            sym.slice_axis(i2h_out, axis=1, begin=0, end=self._h))


def _cell_prefix(prefix, base):
    """Default prefixes auto-number (ref: NameManager — 'lstm0_',
    'lstm1_', ...) so stacking two default-prefix cells never collides;
    explicit duplicate prefixes fail loudly at bind (symbol.py
    check_unique_variables).

    Auto-numbering is per construction: with BucketingModule, construct
    cells ONCE outside sym_gen (the reference's bucketing examples close
    over one stack) or pass explicit prefixes, so every bucket names the
    same parameters."""
    if prefix is not None:
        return prefix
    from .symbol import _auto_name

    return f"{_auto_name(base)}_"


class RNNCell(_GatedCell):
    """ref: rnn_cell.RNNCell — h' = act(i2h(x) + h2h(h))."""

    def __init__(self, num_hidden, activation="tanh", prefix=None):
        super().__init__(num_hidden, _cell_prefix(prefix, "rnn"), n_gates=1)
        self._act = activation

    def __call__(self, x, states):
        t = self._counter
        self._counter += 1
        i2h = self._i2h(x, t)
        if states is None:
            states = [self._zero_state_like(i2h)]
        pre = i2h + self._h2h(states[0], t)
        h = sym.Activation(pre, act_type=self._act,
                           name=f"{self._prefix}out_t{t}")
        return h, [h]


class LSTMCell(_GatedCell):
    """ref: rnn_cell.LSTMCell — gates [i, f, c, o]."""

    num_states = 2

    def __init__(self, num_hidden, prefix=None):
        super().__init__(num_hidden, _cell_prefix(prefix, "lstm"),
                         n_gates=4)

    def __call__(self, x, states):
        t = self._counter
        self._counter += 1
        i2h = self._i2h(x, t)
        if states is None:
            z = self._zero_state_like(i2h)
            states = [z, z]
        h_prev, c_prev = states
        gates = i2h + self._h2h(h_prev, t)
        g = sym.SliceChannel(gates, num_outputs=4, axis=1)
        gi, gf, gc, go = g[0], g[1], g[2], g[3]
        i = sym.Activation(gi, act_type="sigmoid")
        f = sym.Activation(gf, act_type="sigmoid")
        c_tilde = sym.Activation(gc, act_type="tanh")
        o = sym.Activation(go, act_type="sigmoid")
        c = f * c_prev + i * c_tilde
        h = o * sym.Activation(c, act_type="tanh")
        return h, [h, c]


class GRUCell(_GatedCell):
    """ref: rnn_cell.GRUCell — gates [r, z, n], two bias sets."""

    def __init__(self, num_hidden, prefix=None):
        super().__init__(num_hidden, _cell_prefix(prefix, "gru"), n_gates=3)

    def __call__(self, x, states):
        t = self._counter
        self._counter += 1
        gi = self._i2h(x, t)
        if states is None:
            states = [self._zero_state_like(gi)]
        h_prev = states[0]
        gh = self._h2h(h_prev, t)
        si = sym.SliceChannel(gi, num_outputs=3, axis=1)
        sh = sym.SliceChannel(gh, num_outputs=3, axis=1)
        i_r, i_z, i_n = si[0], si[1], si[2]
        h_r, h_z, h_n = sh[0], sh[1], sh[2]
        r = sym.Activation(i_r + h_r, act_type="sigmoid")
        z = sym.Activation(i_z + h_z, act_type="sigmoid")
        n = sym.Activation(i_n + r * h_n, act_type="tanh")
        h = (1 - z) * n + z * h_prev
        return h, [h]


class SequentialRNNCell(BaseRNNCell):
    """ref: rnn_cell.SequentialRNNCell — a stack of cells.  States flow as
    ONE FLAT list sliced by each cell's ``num_states`` (the 1.x state-carry
    contract; a nested per-cell list is not the reference API)."""

    def __init__(self, cells=None):
        super().__init__("")
        self._cells: List[BaseRNNCell] = list(cells or [])

    def add(self, cell):
        self._cells.append(cell)

    @property
    def num_states(self):
        return sum(c.num_states for c in self._cells)

    def _slices(self, states):
        """Per-cell views of the flat state list (None -> all None)."""
        out, pos = [], 0
        for c in self._cells:
            if states is None:
                out.append(None)
            else:
                out.append(states[pos:pos + c.num_states] or None)
            pos += c.num_states
        if states is not None and pos != len(states):
            raise ValueError(
                f"SequentialRNNCell: flat state list has {len(states)} "
                f"entries, the stack needs {pos}")
        return out

    def __call__(self, x, states):
        next_states = []
        for cell, s in zip(self._cells, self._slices(states)):
            x, ns = cell(x, s)
            next_states.extend(ns)
        return x, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        x = inputs
        final_states = []
        for cell, s in zip(self._cells, self._slices(begin_state)):
            x, st = cell.unroll(length, x, begin_state=s, layout=layout,
                                merge_outputs=True)
            final_states.extend(st)
        if not merge_outputs:
            x = _split_inputs(x, length, layout)
        return x, final_states

    def reset(self):
        for c in self._cells:
            c.reset()


class DropoutCell(BaseRNNCell):
    """ref: rnn_cell.DropoutCell — stateless dropout between layers."""

    num_states = 0

    def __init__(self, dropout, prefix="dropout_"):
        super().__init__(prefix)
        self._p = dropout

    def __call__(self, x, states):
        t = self._counter
        self._counter += 1
        return sym.Dropout(x, p=self._p,
                           name=f"{self._prefix}t{t}"), states or []

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Honours the unroll contract: merge_outputs=True -> one merged
        symbol, False -> list of T step symbols, None -> same form as the
        input."""
        self.reset()
        merged_in = not isinstance(inputs, (list, tuple))
        if merged_in:
            out = sym.Dropout(inputs, p=self._p,
                              name=f"{self._prefix}merged")
            if merge_outputs is False:
                return _split_inputs(out, length, layout), begin_state or []
            return out, begin_state or []
        outs = [sym.Dropout(s, p=self._p) for s in inputs]
        if merge_outputs is True:
            return _merge_outputs(outs, layout), begin_state or []
        return outs, begin_state or []


class FusedRNNCell(BaseRNNCell):
    """ref: rnn_cell.FusedRNNCell — the whole stack as ONE fused op call
    (the port's `RNN` op; cuDNN-compatible packed params)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, get_next_state=False, dropout=0.0,
                 prefix=None):
        super().__init__(prefix if prefix is not None else f"{mode}_")
        self._h = num_hidden
        self._l = num_layers
        self._mode = mode
        self._bi = bidirectional
        self._get_next = get_next_state
        self._p = dropout
        self.num_states = (2 if mode == "lstm" else 1) if get_next_state \
            else 0
        self.parameters = sym.Variable(f"{self._prefix}parameters")

    def param_size(self, input_size):
        return rnn_param_size(self._mode, input_size, self._h, self._l,
                              self._bi)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """One RNN-op node; `length` is implicit in the data shape."""
        if isinstance(inputs, (list, tuple)):
            inputs = _merge_outputs(list(inputs), layout)
        data = inputs if layout == "TNC" else sym.transpose(
            inputs, axes=(1, 0, 2), name=f"{self._prefix}tnc")
        args = [data, self.parameters]
        if begin_state:
            args.extend(begin_state)
        out = sym.RNN(*args, state_size=self._h, num_layers=self._l,
                      bidirectional=self._bi, mode=self._mode, p=self._p,
                      name=f"{self._prefix}rnn")
        y = out[0]
        y_l = sym.transpose(y, axes=(1, 0, 2)) if layout == "NTC" else y
        if merge_outputs is False:
            y_l = _split_inputs(y_l, length, layout)
        states = [out[1]] + ([out[2]] if self._mode == "lstm" else []) \
            if self._get_next else []
        return y_l, states