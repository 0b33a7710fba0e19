"""Word-level RNN language models (the port of
``mxnet_tpu/gluon/model_zoo/language_model.py``; BASELINE config 3, the
PTB recipe): embedding, a fused ``LSTM``/``GRU``/``RNN`` stack and a
dense decoder, optionally tied to the embedding.

With ``tie_weights`` the decoder reads the embedding's parameter inside
``forward``; under ``functional_call`` (``TrainStep``, ``hybridize()``)
that read is the tensor standing in for it, so the gradient of both
uses reaches the one parameter.
"""
from __future__ import annotations

import torch

from .. import nn, rnn
from ..block import HybridBlock

__all__ = ["RNNModel", "rnn_lm"]


class RNNModel(HybridBlock):
    """``forward(x)`` -> ``(T, N, vocab)`` logits of ``(T, N)`` token
    ids; with ``states`` -> ``(logits, states)``, for a training loop
    that carries the state across segments."""

    def __init__(self, mode="lstm", vocab_size=10000, embed_size=650,
                 hidden_size=650, num_layers=2, dropout=0.5,
                 tie_weights=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if tie_weights and embed_size != hidden_size:
            raise ValueError("tie_weights requires embed_size == hidden_size")
        self._tie = tie_weights
        self._vocab_size = vocab_size
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.embedding = nn.Embedding(vocab_size, embed_size)
            if mode == "lstm":
                self.rnn = rnn.LSTM(hidden_size, num_layers, layout="TNC",
                                    dropout=dropout, input_size=embed_size)
            elif mode == "gru":
                self.rnn = rnn.GRU(hidden_size, num_layers, layout="TNC",
                                   dropout=dropout, input_size=embed_size)
            elif mode in ("rnn_relu", "rnn_tanh"):
                self.rnn = rnn.RNN(hidden_size, num_layers,
                                   activation=mode[4:], layout="TNC",
                                   dropout=dropout, input_size=embed_size)
            else:
                raise ValueError(f"unknown mode {mode!r}")
            if tie_weights:
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,), init="zeros")
            else:
                self.decoder = nn.Dense(vocab_size, in_units=hidden_size,
                                        flatten=False)

    def forward(self, x, states=None):
        emb = self.drop(self.embedding(x))
        if states is None:
            out = self.rnn(emb)
        else:
            out, states = self.rnn(emb, [getattr(s, "_data", s)
                                         for s in states])
        out = self.drop(out)
        if self._tie:
            logits = torch.nn.functional.linear(
                out, self.embedding.weight.tensor(),
                self.decoder_bias.tensor())
        else:
            logits = self.decoder(out)
        if states is None:
            return logits
        return logits, states


def rnn_lm(mode="lstm", vocab_size=10000, **kwargs):
    """The reference example's model by its CLI presets."""
    return RNNModel(mode=mode, vocab_size=vocab_size, **kwargs)
