"""gluon.rnn of the port: the fused layers over the ``RNN`` op and the
unfused cells."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, ZoneoutCell,
                       ResidualCell, BidirectionalCell)

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]
