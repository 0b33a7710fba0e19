"""Port parity: ``mxnet_tpu_torch.gluon.model_zoo.causal_lm`` against
the JAX package's causal LM, on the CPU.

The JAX param dict goes across with ``params_from_jax``; inputs are
seeded numpy arrays.  Weights are drawn with std 0.3 (not the init's
0.02) so logits are well separated.  Tolerance: rtol = atol = 1e-4 on
logits and hidden states, 1e-5 on K/V — float32 on both sides, summed
in a different order.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.gluon.model_zoo import causal_lm as jlm
from mxnet_tpu.ops.attention import _multi_head_attention as jax_mha
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm
from mxnet_tpu_torch.ops.attention import multi_head_attention

CFG = dict(vocab_size=48, n_layers=2, n_heads=2, head_dim=8, d_ff=32)
JCFG, TCFG = jlm.CausalLMConfig(**CFG), tlm.CausalLMConfig(**CFG)
TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


def loud_params(seed=3, std=0.3):
    """The JAX init's names and shapes, weights redrawn with ``std``
    (biases and norm offsets small but nonzero, so every term counts)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in jlm.init_causal_lm(JCFG, seed).items():
        shape = np.asarray(v).shape
        if k in ("embed", "wqkv", "wo", "w1", "w2"):
            out[k] = (std * rng.randn(*shape)).astype(np.float32)
        elif k.endswith("_s"):
            out[k] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[k] = (0.05 * rng.randn(*shape)).astype(np.float32)
    return out


NP = loud_params()
JP = {k: jnp.asarray(v) for k, v in NP.items()}
TP = tlm.params_from_jax(NP, device="cpu")


def _tokens(seed, b, L):
    rng = np.random.RandomState(seed)
    return rng.randint(0, CFG["vocab_size"], size=(b, L)).astype(np.int32)


def test_params_from_jax_keeps_names_shapes_values():
    assert set(TP) == set(NP)
    for k, v in NP.items():
        assert TP[k].dtype == torch.float32 and TP[k].device.type == "cpu"
        np.testing.assert_array_equal(TP[k].numpy(), v)


@pytest.mark.parametrize("lengths", [(8, 8), (5, 8), (1, 3), (8, 0)])
def test_prefill_forward_matches_jax(lengths):
    toks = _tokens(0, 2, 8)
    lens = np.asarray(lengths, np.int32)
    lj, kj, vj = jlm.prefill_forward(JP, JCFG, jnp.asarray(toks),
                                     jnp.asarray(lens))
    lt, kt, vt = tlm.prefill_forward(TP, TCFG, torch.from_numpy(toks),
                                     torch.from_numpy(lens))
    assert tuple(kt.shape) == (2, 2, 8, 2, 8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **KV_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **KV_TOL)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_sequence_logits_matches_jax(with_lengths):
    toks = _tokens(1, 3, 7)
    lens = np.asarray([7, 4, 2], np.int32) if with_lengths else None
    lj = jlm.sequence_logits(JP, JCFG, jnp.asarray(toks),
                             None if lens is None else jnp.asarray(lens))
    lt = tlm.sequence_logits(TP, TCFG, torch.from_numpy(toks),
                             None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_decode_hidden_matches_jax(layer):
    """One single-token layer with a cache hook that records q/K/V and
    returns a fixed mix of them — both sides see identical hooks."""
    rng = np.random.RandomState(2)
    h = rng.randn(4, TCFG.d_model).astype(np.float32)
    seen = {}

    def j_attend(q, k, v):
        seen["jq"] = np.asarray(q)
        return 0.5 * v + 0.25 * q

    def t_attend(q, k, v):
        seen["tq"] = q.numpy()
        return 0.5 * v + 0.25 * q

    oj = jlm.decode_hidden(JP, layer, jnp.asarray(h), j_attend)
    ot = tlm.decode_hidden(TP, layer, torch.from_numpy(h), t_attend)
    np.testing.assert_allclose(seen["tq"], seen["jq"], **KV_TOL)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)


def test_lm_logits_matches_jax():
    h = np.random.RandomState(4).randn(5, TCFG.d_model).astype(np.float32)
    np.testing.assert_allclose(
        tlm.lm_logits(TP, torch.from_numpy(h)).numpy(),
        np.asarray(jlm.lm_logits(JP, jnp.asarray(h))), **TOL)


def test_layer_norm_eps_and_gelu_approximation_match_jax():
    """The two numeric traps: ``_ln`` eps 1e-6 (torch's default is
    1e-5) and ``jax.nn.gelu``'s tanh approximation.  A near-constant
    row makes the eps visible."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 16).astype(np.float32)
    x[0] = 1.0 + 1e-4 * x[0]                     # variance ~1e-8
    s = rng.randn(16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    np.testing.assert_allclose(
        tlm._ln(*(torch.from_numpy(a) for a in (x, s, b))).numpy(),
        np.asarray(jlm._ln(*(jnp.asarray(a) for a in (x, s, b)))),
        rtol=1e-4, atol=1e-4)
    z = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(z),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(z))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax_with_padded_rows(causal):
    """Key masks with an all-masked row stay finite (the ``-1e30`` fill)
    and match the JAX op."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 5, 16).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 1, 1, 5), np.float32)
    mask[1, ..., :] = 0.0                        # a fully padded row
    mask[0, ..., 3:] = 0.0
    oj = jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                 mask=jnp.asarray(mask), heads=2, causal=causal,
                 dropout=0.0, training=False)
    ot = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              mask=torch.from_numpy(mask), heads=2,
                              causal=causal)
    assert torch.isfinite(ot).all()
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)


def test_init_causal_lm_is_seeded_by_generator():
    a = tlm.init_causal_lm(TCFG, torch.Generator().manual_seed(7),
                           device="cpu")
    b = tlm.init_causal_lm(TCFG, torch.Generator().manual_seed(7),
                           device="cpu")
    c = tlm.init_causal_lm(TCFG, torch.Generator().manual_seed(8),
                           device="cpu")
    assert set(a) == set(NP)
    for k in a:
        assert tuple(a[k].shape) == NP[k].shape
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["embed"], c["embed"])


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_causal_lm(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.params_from_jax(NP)
