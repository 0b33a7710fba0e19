"""BERT (the port of ``mxnet_tpu/gluon/model_zoo/bert.py``).

``BERTModel`` / ``BERTEncoder`` / ``BERTLayer`` / ``BERTAttentionCell``
and ``BERTPretrainLoss`` with the JAX package's structure, parameter
names and output order: batch-major ``(B, S, C)`` activations, one
fused QKV projection per layer (block ``[Q; K; V]`` along the output
dim), post-LN layers, the masked-LM decoder tied to
``word_embed.weight`` (its gradient is the sum of both uses) and the
masked positions gathered with ``gather_nd``.

``attention_impl`` is ``"dense"`` (``F.multi_head_attention``) or
``"flash"`` (``F.flash_attention``: the hand-written flash-attention
kernels on the card).  As in the JAX package the flash path takes no
``valid_length`` mask; ``"ring"`` and ``"ulysses"`` need a device mesh,
which the port does not have yet.

``params_from_jax`` (the zoo's, shared with ResNet) copies a JAX BERT's
parameters into a port BERT of the same configuration, by name with
each net's own prefix stripped.
"""
from __future__ import annotations

import torch

from ... import initializer as init_mod
from ... import ops as F
from ..block import HybridBlock
from ..loss import SoftmaxCrossEntropyLoss
from ..nn import Dense, Dropout, Embedding, LayerNorm
from .vision.resnet import params_from_jax

__all__ = ["BERTAttentionCell", "BERTEncoder", "BERTLayer", "BERTModel",
           "BERTPretrainLoss", "bert_12_768_12", "bert_24_1024_16",
           "get_bert_model", "params_from_jax"]


def _trunc_norm():
    return init_mod.TruncNorm(stdev=0.02)


class BERTAttentionCell(HybridBlock):
    """Self-attention with one fused QKV projection, then the output
    projection and dropout."""

    def __init__(self, units, num_heads, dropout=0.0, in_units=0,
                 attention_impl="dense", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert units % num_heads == 0
        if attention_impl not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attention_impl '{attention_impl}' "
                             "(expected 'dense', 'flash', 'ring', or "
                             "'ulysses')")
        if attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl='{attention_impl}' runs over a device "
                f"mesh, which the port does not have yet")
        self._units = units
        self._heads = num_heads
        self._dropout = dropout
        self._impl = attention_impl
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False,
                             in_units=in_units or units,
                             weight_initializer=_trunc_norm())
            self.proj = Dense(units, flatten=False, in_units=units,
                              weight_initializer=_trunc_norm())
            self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).split(self._units, dim=-1)   # (B, S, C) each
        if self._impl == "flash":
            if mask is not None:
                raise ValueError("attention_impl='flash' does not support "
                                 "valid_length masks yet")
            out = F.flash_attention(q, k, v, heads=self._heads,
                                    dropout=self._dropout)
        else:
            out = F.multi_head_attention(q, k, v, mask, heads=self._heads,
                                         dropout=self._dropout)
        return self.dropout(self.proj(out))


class BERTLayer(HybridBlock):
    """Post-LN transformer encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_impl="dense", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attention = BERTAttentionCell(units, num_heads,
                                               dropout=dropout,
                                               attention_impl=attention_impl)
            self.ln1 = LayerNorm(in_channels=units, epsilon=1e-12)
            self.ffn1 = Dense(hidden_size, flatten=False, activation="gelu",
                              in_units=units,
                              weight_initializer=_trunc_norm())
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                              weight_initializer=_trunc_norm())
            self.dropout = Dropout(dropout)
            self.ln2 = LayerNorm(in_channels=units, epsilon=1e-12)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        h = self.dropout(self.ffn2(self.ffn1(x)))
        return self.ln2(x + h)


class BERTEncoder(HybridBlock):
    """A stack of ``BERTLayer``s."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attention_impl="dense",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.layers = []
            for i in range(num_layers):
                layer = BERTLayer(units, hidden_size, num_heads,
                                  dropout=dropout,
                                  attention_impl=attention_impl)
                self.register_child(layer, f"layer{i}")
                self.layers.append(layer)

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """``forward(inputs, token_types, valid_length=None,
    masked_positions=None)`` -> ``(sequence_output, pooled_output
    [, nsp_scores][, mlm_scores])``, in the JAX package's order: the NSP
    scores when ``use_classifier``, the MLM scores when
    ``masked_positions`` is given and ``use_decoder``."""

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 units=768, hidden_size=3072, num_layers=12, num_heads=12,
                 max_length=512, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True,
                 attention_impl="dense", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        if use_classifier and not use_pooler:
            raise ValueError("use_classifier=True requires use_pooler=True "
                             "(the NSP head reads the pooled [CLS] output)")
        tn = _trunc_norm()
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        weight_initializer=tn)
            self.token_type_embed = Embedding(token_type_vocab_size, units,
                                              weight_initializer=tn)
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init=tn)
            self.embed_ln = LayerNorm(in_channels=units, epsilon=1e-12)
            self.embed_dropout = Dropout(dropout)
            self.encoder = BERTEncoder(num_layers=num_layers, units=units,
                                       hidden_size=hidden_size,
                                       num_heads=num_heads, dropout=dropout,
                                       attention_impl=attention_impl)
            if use_pooler:
                self.pooler = Dense(units, flatten=False, activation="tanh",
                                    in_units=units, weight_initializer=tn)
            if use_classifier:
                self.classifier = Dense(2, flatten=False, in_units=units,
                                        weight_initializer=tn)
            if use_decoder:
                # the MLM head's output projection is word_embed.weight
                self.decoder_transform = Dense(units, flatten=False,
                                               activation="gelu",
                                               in_units=units,
                                               weight_initializer=tn)
                self.decoder_ln = LayerNorm(in_channels=units, epsilon=1e-12)
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,), init="zeros")

    def _embed(self, inputs, token_types):
        x = self.word_embed(inputs) + self.token_type_embed(token_types)
        pos = self.position_weight.tensor()[:inputs.shape[1]]
        return self.embed_dropout(self.embed_ln(x + pos.unsqueeze(0)))

    def forward(self, inputs, token_types, valid_length=None,
                masked_positions=None):
        x = self._embed(inputs, token_types)
        mask = None
        if valid_length is not None:
            steps = torch.arange(inputs.shape[1], device=inputs.device)
            # (B, 1, 1, S_k): key positions >= valid_length are masked out
            mask = (steps[None, :] < valid_length.to(inputs.device)[:, None]) \
                [:, None, None, :]
        seq_out = self.encoder(x, mask)
        outputs = [seq_out]
        if self._use_pooler:
            pooled = self.pooler(seq_out[:, 0])
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.classifier(pooled))
        if self._use_decoder and masked_positions is not None:
            sel = _take_along_seq(seq_out, masked_positions)    # (B, M, C)
            h = self.decoder_ln(self.decoder_transform(sel))
            w = self.word_embed.weight.tensor()                   # (V, C)
            mlm = F.dot(h.reshape(-1, self._units), w, transpose_b=True)
            mlm = mlm.reshape(inputs.shape[0], -1, w.shape[0]) \
                + self.decoder_bias.tensor().reshape(1, 1, -1)
            outputs.append(mlm)
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


def _take_along_seq(seq, positions):
    """The ``(B, M, C)`` rows of ``(B, S, C)`` at int positions ``(B, M)``."""
    b, m = positions.shape
    batch_idx = torch.arange(b, device=seq.device).reshape(b, 1) \
        .expand(b, m)
    idx = torch.stack((batch_idx, positions.to(seq.device).long()))
    return F.gather_nd(seq, idx)


class BERTPretrainLoss(HybridBlock):
    """Masked-LM + next-sentence loss: ``call(mlm_scores, nsp_scores,
    mlm_labels, mlm_weights, nsp_labels)`` -> the weighted mean masked CE
    plus the mean NSP CE (a scalar in the scores' dtype)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._ce = SoftmaxCrossEntropyLoss()

    def forward(self, mlm_scores, nsp_scores, mlm_labels, mlm_weights,
                nsp_labels):
        v = mlm_scores.shape[-1]
        mlm_l = self._ce(mlm_scores.reshape(-1, v), mlm_labels.reshape(-1))
        w = mlm_weights.reshape(-1).to(mlm_l.dtype)
        mlm_loss = (mlm_l * w).sum() / w.sum().clamp_min(1e-5)
        nsp_loss = self._ce(nsp_scores, nsp_labels).mean()
        return mlm_loss + nsp_loss


_BERT_CONFIGS = {
    # name: (num_layers, units, hidden, heads)
    "bert_12_768_12": (12, 768, 3072, 12),
    "bert_24_1024_16": (24, 1024, 4096, 16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   max_length=512, dropout=0.1, **kwargs):
    """A BERT of a published size by name."""
    layers, units, hidden, heads = _BERT_CONFIGS[model_name]
    return BERTModel(vocab_size=vocab_size, units=units, hidden_size=hidden,
                     num_layers=layers, num_heads=heads,
                     max_length=max_length, dropout=dropout, **kwargs)


def bert_12_768_12(**kwargs):
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    return get_bert_model("bert_24_1024_16", **kwargs)
