"""Fused recurrent layers (the port of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and ``GRU``
over the ``RNN`` op (``ops/rnn.py``), their weights packed in one
vector in the JAX package's layout, so parameter files load in either
package.

A call with states returns ``(out, states)``; without, ``out`` alone
(the states start at zero).  The zero states take the dtype of the
packed parameter, so ``net.cast("bfloat16")`` casts them too: torch's
recurrent ops take no mixed dtypes, where JAX would promote silently.
"""
from __future__ import annotations

from ...ops.rnn import rnn_param_size
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


def _states_of(states):
    """The states of a call as a tuple: given spread out, as one list or
    tuple, or None."""
    if len(states) == 1:
        st = states[0]
        if st is None:
            return ()
        if isinstance(st, (list, tuple)):
            return tuple(st)
    return tuple(states)


class _RNNLayer(HybridBlock):
    """The fused layer: one packed parameter ``rnn_param``, sized at
    the first forward when ``input_size`` is 0."""

    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), "layout must be TNC or NTC"
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        psize = (rnn_param_size(mode, input_size, hidden_size, num_layers,
                                bidirectional) if input_size else 0)
        self.parameters = self.params.get(
            "rnn_param", shape=(psize,), init=i2h_weight_initializer,
            dtype=dtype, allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self._input_size = x.shape[-1]
        self.parameters.shape = (rnn_param_size(
            self._mode, self._input_size, self._hidden_size,
            self._num_layers, self._dir == 2),)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (NDArrays) on ``ctx`` (None: the current
        context) in the layer's dtype."""
        from ... import ndarray as nd
        return [nd.zeros(info["shape"], ctx=kwargs.get("ctx"),
                         dtype=self.parameters.dtype)
                for info in self.state_info(batch_size)]

    def __call__(self, x, *states):
        return super().__call__(x, *_states_of(states))

    def hybrid_forward(self, F, x, *states, parameters):
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        given = bool(states)
        if not given:
            states = tuple(parameters.new_zeros(info["shape"]) for info in
                           self.state_info(x.shape[1]))
        outs = F.RNN(x, parameters, *states, state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, mode=self._mode,
                     p=self._dropout, state_outputs=True)
        out = outs[0].transpose(0, 1) if self._layout == "NTC" else outs[0]
        return (out, list(outs[1:])) if given else out

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers})")


class RNN(_RNNLayer):
    """Vanilla RNN (``activation`` relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers, layout,
                         dropout, bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM — the word language model's recurrence."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU (gate order r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
