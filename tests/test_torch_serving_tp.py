"""Port parity: tensor-parallel LLM serving — ``GenerationServer(
tp_shards=2, tp_collectives=...)`` on a gang of two gloo ranks on the
CPU — against the port's single-rank server and the JAX package's tp=2
server (two of the virtual CPU devices), the port's counterparts of
``tests/test_generate.py``'s tensor-parallel cases at its sizes
(``CFG``, ``LOUD``; ``TP8_CFG``'s eight heads run four a rank here).

One gang of two port workers (this file run as a script through
``python -m mxnet_tpu_torch.launch -n 2 --platform cpu``) is started once
for the module; both ranks build every server with the same arguments,
rank 0 (the leader) submits and records, rank 1 (the follower) records
what it can see.  The params come across as numpy arrays
(``params_from_jax``).  Besides f32 and int8 collectives: the
speculative verify step over tp=2 (the draft whole on every rank), and
disaggregated prefill with one and two workers (the JAX package's
``test_tp_disaggregated_handoff_sharded``).

Also, with no gang: ``tp_permute_qkv`` and ``tp_param_specs`` against
the JAX package's, and two shards of ``decode_hidden`` run side by side
with their partial products summed by hand against the JAX package's
``decode_hidden`` with a ``reduce`` hook; the JAX package's validation
errors; and on the card (``gpu``), the paged kernel on one rank's pool
at the serving shape's local heads against its plain version.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

PROMPTS = ([5, 9, 2, 7, 1], [3, 1], [11, 4, 6], [8])
INT8_PROMPTS = ([5, 9, 2], [7, 1, 3])
MIXED = 6                                  # the TP8 mixed-sampling requests


def mixed_requests():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 48, size=int(rng.randint(1, 8))).astype(np.int32),
             dict(max_new_tokens=int(rng.randint(1, 4)),
                  temperature=float(i % 2), top_k=int(3 * (i % 2))))
            for i in range(MIXED)]


def port_server(tmx, params, cfg, name, buckets=(1,), **kw):
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("seed", 0)
    return GenerationServer(params, cfg, buckets=BucketSpec(
        batch=buckets, length=(8,)), device="cpu", name=name, **kw)


def serve(srv, requests, leader):
    """Every rank starts and drains; the leader submits ``requests``
    (``(prompt, kwargs)``) and returns their tokens, a follower what it
    sees of itself."""
    from mxnet_tpu_torch.serving import RejectedError

    srv.start()
    if leader:
        h = srv.healthz()
        outs = [srv.submit(p, **kw).result(120) for p, kw in requests]
        drained = srv.drain(60)
        return {"outs": outs, "drained": drained,
                "tp": (h["tp_shards"], h["tp_collectives"]),
                "free": srv.alloc.free_count() == srv.alloc.allocatable,
                "graphs": srv.graph_count(), "census": srv.census(),
                "decode_steps": srv.stats["decode_steps"]
                + srv.stats["verify_steps"],
                "handoffs": srv.stats["handoffs"]}
    try:
        srv.submit(np.asarray([1, 2], np.int32))
        refused = ""
    except RejectedError as exc:
        refused = str(exc)
    drained = srv.drain(120)
    return {"refused": refused, "drained": drained,
            "loop_alive": srv.alive(), "graphs": srv.graph_count(),
            "handoffs": srv.stats["handoffs"],
            "left": len(srv._pf_payloads)}


def worker(outdir):
    """One rank: every server, its results to ``rank<r>.npz``."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.gluon.model_zoo import causal_lm as lm

    r, n = distributed.rank(), distributed.num_workers()
    assert n == 2 and distributed.backend() == "gloo"
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    cfg = lm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=2,
                            head_dim=8, d_ff=32)
    cfg8 = lm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=8,
                             head_dim=2, d_ff=32)
    loud = lm.params_from_jax({k[5:]: v for k, v in inputs.items()
                               if k.startswith("loud/")}, device="cpu")
    tp8 = lm.params_from_jax({k[4:]: v for k, v in inputs.items()
                              if k.startswith("tp8/")}, device="cpu")
    draft_cfg = lm.draft_config(cfg, n_layers=1)
    draft = lm.params_from_jax({k[6:]: v for k, v in inputs.items()
                                if k.startswith("draft/")}, device="cpu")
    leader = r == 0
    res = {}
    reqs = [(np.asarray(p, np.int32), {}) for p in PROMPTS]

    def put(tag, got):
        for k, v in got.items():
            if k == "outs":
                for i, o in enumerate(v):
                    res[f"{tag}/out{i}"] = np.asarray(o)
            else:
                res[f"{tag}/{k}"] = np.asarray(v)

    with tmx.cpu():
        if leader:       # the world of one, beside the gang
            put("single", serve(port_server(tmx, loud, cfg, "one"), reqs,
                                True))
            put("single8", serve(port_server(
                tmx, tp8, cfg8, "one8", buckets=(1, 2), n_slots=4,
                max_new_tokens=3), mixed_requests(), True))
            put("single_spec", serve(port_server(
                tmx, loud, cfg, "onespec", draft=draft,
                draft_config=draft_cfg, spec_k=2), reqs, True))
        put("f32", serve(port_server(tmx, loud, cfg, "tp2", tp_shards=2),
                         reqs, leader))
        for i in range(2):
            put(f"int8_{i}", serve(port_server(
                tmx, loud, cfg, f"tp2q{i}", tp_shards=2,
                tp_collectives="int8", max_new_tokens=6),
                [(np.asarray(p, np.int32), {}) for p in INT8_PROMPTS],
                leader))
        put("f32_6", serve(port_server(
            tmx, loud, cfg, "tp2f6", tp_shards=2, max_new_tokens=6),
            [(np.asarray(p, np.int32), {}) for p in INT8_PROMPTS], leader))
        put("tp8", serve(port_server(
            tmx, tp8, cfg8, "tp8", buckets=(1, 2), n_slots=4,
            max_new_tokens=3, tp_shards=2), mixed_requests(), leader))
        put("spec", serve(port_server(
            tmx, loud, cfg, "tp2spec", tp_shards=2, draft=draft,
            draft_config=draft_cfg, spec_k=2), reqs, leader))
        for w in (1, 2):
            put(f"dis{w}", serve(port_server(
                tmx, loud, cfg, f"tp2dis{w}", buckets=(1, 2), n_slots=4,
                tp_shards=2, prefill_workers=w), reqs, leader))
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.gluon.model_zoo import causal_lm as jlm  # noqa: E402
from mxnet_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from mxnet_tpu.serving import BucketSpec as JBucketSpec  # noqa: E402
from mxnet_tpu.serving import GenerationServer as JServer  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm  # noqa: E402
from mxnet_tpu_torch.parallel import make_mesh  # noqa: E402
from mxnet_tpu_torch.serving import BucketSpec  # noqa: E402
from mxnet_tpu_torch.serving import GenerationServer  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                start_gang)

CFG = jlm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=2, head_dim=8,
                         d_ff=32)
TP8_CFG = jlm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=8,
                             head_dim=2, d_ff=32)
TCFG = tlm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=2, head_dim=8,
                          d_ff=32)


def _loud(params):
    return {k: np.asarray(v * 8.0 if k in ("embed", "wqkv", "wo", "w1", "w2")
                          else v, np.float32) for k, v in params.items()}


LOUD = _loud(jlm.init_causal_lm(CFG, seed=3))
TP8_LOUD = _loud(jlm.init_causal_lm(TP8_CFG, seed=5))
DRAFT = {k: np.asarray(v, np.float32) for k, v in jlm.init_causal_lm(
    jlm.draft_config(CFG, n_layers=1), seed=4).items()}


def jax_tokens(params, cfg, requests, buckets=(1,), **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 8)
    srv = JServer({k: jnp.asarray(v) for k, v in params.items()}, cfg,
                  buckets=JBucketSpec(batch=buckets, length=(8,)), seed=0,
                  name=f"JTP-{time.monotonic_ns()}", **kw).start()
    try:
        return [np.asarray(srv.submit(np.asarray(p, np.int32), **k)
                           .result(120)) for p, k in requests]
    finally:
        assert srv.drain(60)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("serving_tp"))
    inputs = {f"loud/{k}": v for k, v in LOUD.items()}
    inputs.update({f"tp8/{k}": v for k, v in TP8_LOUD.items()})
    inputs.update({f"draft/{k}": v for k, v in DRAFT.items()})
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    proc = start_gang(os.path.abspath(__file__), outdir)
    try:
        reqs = [(p, {}) for p in PROMPTS]
        jax_side = {"single": jax_tokens(LOUD, CFG, reqs),
                    "tp2": jax_tokens(LOUD, CFG, reqs, tp_shards=2)}
    except BaseException:
        kill_gang(proc)
        raise
    return finish_gang(proc, outdir), jax_side


def outs(res, tag, n):
    return [res[f"{tag}/out{i}"] for i in range(n)]


# ------------------------------------------------------------- the tests --
def test_tp2_f32_greedy_tokens_equal_single_rank_and_jax(gang):
    """tp=2 with f32 collectives: token for token the port's single-rank
    server's, the JAX package's tp=2 server's and its single-chip
    server's, over prompts that cross page boundaries."""
    (r0, _), jax_side = gang
    got = outs(r0, "f32", len(PROMPTS))
    for g, one, jt, js in zip(got, outs(r0, "single", len(PROMPTS)),
                              jax_side["tp2"], jax_side["single"]):
        np.testing.assert_array_equal(g, one)
        np.testing.assert_array_equal(g, jt)
        np.testing.assert_array_equal(g, js)
        assert len(g) == 8


def test_tp2_int8_first_token_exact_and_deterministic(gang):
    (r0, _), _ = gang
    n = len(INT8_PROMPTS)
    f32 = outs(r0, "f32_6", n)
    for w, a, b in zip(f32, outs(r0, "int8_0", n), outs(r0, "int8_1", n)):
        assert a[0] == w[0]                  # prefill: f32 collectives
        assert len(a) == len(w) == 6
        assert all(0 <= t < 48 for t in a)
        np.testing.assert_array_equal(a, b)


def test_tp2_four_heads_a_rank_mixed_sampling_equals_single_rank(gang):
    """TP8_CFG's eight heads, four on each rank, under mixed greedy and
    seeded top-k traffic: the single-rank server's tokens."""
    (r0, _), _ = gang
    for a, b in zip(outs(r0, "tp8", MIXED), outs(r0, "single8", MIXED)):
        np.testing.assert_array_equal(a, b)
    assert int(r0["tp8/decode_steps"]) > 0


def test_tp2_speculative_equals_single_rank(gang):
    """The verify step over tp=2 (the draft whole on every rank): the
    single-rank speculative server's greedy tokens, and the plain
    server's."""
    (r0, _), _ = gang
    n = len(PROMPTS)
    for a, b, c in zip(outs(r0, "spec", n), outs(r0, "single_spec", n),
                       outs(r0, "single", n)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("tag", ("f32", "int8_0", "int8_1", "tp8", "spec",
                                 "dis1", "dis2"))
def test_tp2_health_drain_and_pages(gang, tag):
    """``healthz()`` reports ``tp_shards``/``tp_collectives``; the
    follower refuses ``submit``; the leader's drain ends the follower's
    loop; every page is free; over gloo the steps run eagerly."""
    (r0, r1), _ = gang
    assert list(r0[f"{tag}/tp"]) == \
        ["2", "int8" if tag.startswith("int8") else "f32"]
    assert bool(r0[f"{tag}/drained"]) and bool(r0[f"{tag}/free"])
    assert "follows the tensor-parallel leader" in str(r1[f"{tag}/refused"])
    assert bool(r1[f"{tag}/drained"]) and not bool(r1[f"{tag}/loop_alive"])
    assert int(r0[f"{tag}/graphs"]) == int(r1[f"{tag}/graphs"]) == 0


@pytest.mark.parametrize("workers", (1, 2))
def test_tp2_disaggregated_equals_single_rank_fused(gang, workers):
    """Disaggregated prefill composes with tp=2 (the JAX package's
    ``test_tp_disaggregated_handoff_sharded``): the pool-free prefills on
    the leader's workers, announced over the prefill group and run on
    each rank's heads, handed off by id — the single-rank fused server's
    tokens, census grid + 2, every payload consumed, pages free."""
    (r0, r1), _ = gang
    tag = f"dis{workers}"
    for a, b in zip(outs(r0, tag, len(PROMPTS)),
                    outs(r0, "single", len(PROMPTS))):
        np.testing.assert_array_equal(a, b)
    assert int(r0[f"{tag}/census"]) == 2 * 1 + 2
    assert int(r0[f"{tag}/handoffs"]) >= 1
    assert int(r1[f"{tag}/handoffs"]) >= int(r0[f"{tag}/handoffs"])
    assert int(r1[f"{tag}/left"]) == 0
    assert bool(r0[f"{tag}/free"]) and bool(r1[f"{tag}/drained"])


@pytest.mark.parametrize("shards", (2, 4))
def test_tp_permute_qkv_equals_jax(shards):
    want = jlm.tp_permute_qkv(TP8_LOUD, TP8_CFG, shards)
    got = tlm.tp_permute_qkv(tlm.params_from_jax(TP8_LOUD, device="cpu"),
                             tlm.CausalLMConfig(**vars(TP8_CFG)), shards)
    for k in ("wqkv", "bqkv"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np_got = tlm.tp_permute_qkv(TP8_LOUD, TP8_CFG, shards)
    np.testing.assert_array_equal(np_got["wqkv"], np.asarray(want["wqkv"]))


def test_tp_param_specs_equal_jax():
    jspecs = jlm.tp_param_specs(
        TP8_CFG, jmake_mesh(tp=2, devices=jax.devices()[:2]))
    tspecs = tlm.tp_param_specs(tlm.CausalLMConfig(**vars(TP8_CFG)),
                                make_mesh(tp=2, devices=[0, 1]))
    assert sorted(jspecs) == sorted(tspecs)
    for k in jspecs:
        assert tuple(jspecs[k]) == tuple(tspecs[k]), k


def _shard(params, cfg, s, shards=2):
    """Shard ``s`` of ``shards`` of the permuted params, by hand."""
    p = tlm.tp_permute_qkv(params, cfg, shards)
    d3, ff = 3 * cfg.d_model, cfg.d_ff
    d = cfg.d_model
    out = dict(p)
    for k, n, dim in (("wqkv", d3, -1), ("bqkv", d3, -1), ("w1", ff, -1),
                      ("b1", ff, -1), ("wo", d, 1), ("w2", ff, 1)):
        size = n // shards
        out[k] = p[k].narrow(dim, s * size, size)
    return out


def test_two_shards_of_decode_hidden_sum_to_jax_with_reduce():
    """Two shards of the port's ``decode_hidden`` side by side (a thread
    each), the partial products summed by hand at each reduce, against
    the JAX package's ``decode_hidden`` with a ``reduce`` hook on the
    whole params: within 1e-5."""
    rng = np.random.RandomState(2)
    h = rng.randn(3, TP8_CFG.d_model).astype(np.float32)
    tcfg = tlm.CausalLMConfig(**vars(TP8_CFG))
    whole = tlm.params_from_jax(TP8_LOUD, device="cpu")
    want = np.asarray(jlm.decode_hidden(
        {k: jnp.asarray(v) for k, v in TP8_LOUD.items()}, 1, jnp.asarray(h),
        lambda q, k, v: v, reduce=lambda x: x))
    barrier = threading.Barrier(2)
    parts, got = [None, None], [None, None]

    def run(s):
        def reduce(x):
            parts[s] = x
            barrier.wait()
            total = parts[0] + parts[1]
            barrier.wait()
            return total
        got[s] = tlm.decode_hidden(_shard(whole, tcfg, s), 1,
                                   torch.from_numpy(h), lambda q, k, v: v,
                                   reduce=reduce)
    threads = [threading.Thread(target=run, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())


def test_reduce_none_keeps_the_single_card_expression():
    """``reduce=None`` is the pre-tensor-parallel body, bit for bit: the
    whole params through ``decode_hidden`` against the same layer
    written out."""
    rng = np.random.RandomState(3)
    p = tlm.params_from_jax(LOUD, device="cpu")
    h = torch.from_numpy(rng.randn(2, 16).astype(np.float32))
    got = tlm.decode_hidden(p, 0, h, lambda q, k, v: v)
    x = tlm._ln(h, p["ln1_s"][0], p["ln1_b"][0])
    v = (x @ p["wqkv"][0] + p["bqkv"][0]).chunk(3, dim=-1)[2]
    h2 = h + v @ p["wo"][0] + p["bo"][0]
    want = h2 + tlm._ffn(tlm._ln(h2, p["ln2_s"][0], p["ln2_b"][0]),
                         p["w1"][0], p["b1"][0], p["w2"][0], p["b2"][0])
    assert torch.equal(got, want)


def _make(params=None, cfg=TCFG, **kw):
    return GenerationServer(
        tlm.params_from_jax(LOUD if params is None else params,
                            device="cpu"), cfg,
        buckets=BucketSpec(batch=(1,), length=(8,)), device="cpu",
        name=f"TPval-{time.monotonic_ns()}", **kw)


def test_tp_validation_errors_match_jax():
    """The JAX package's texts: a head count the shards cannot divide,
    an unknown collective format, more shards than devices (here the
    ranks of the gang's tp axis), a d_ff the shards cannot divide."""
    with pytest.raises(ValueError, match="n_heads"):
        _make(tp_shards=3)
    with pytest.raises(ValueError, match="tp_collectives"):
        _make(tp_shards=2, tp_collectives="bf16")
    cfg16 = tlm.CausalLMConfig(vocab_size=48, n_layers=1, n_heads=16,
                               head_dim=2, d_ff=32)
    with pytest.raises(ValueError, match="devices"):
        GenerationServer(tlm.init_causal_lm(cfg16, device="cpu"), cfg16,
                         tp_shards=16, device="cpu",
                         buckets=BucketSpec(batch=(1,), length=(8,)))
    cfg = tlm.CausalLMConfig(vocab_size=48, n_layers=1, n_heads=4,
                             head_dim=4, d_ff=30)
    with pytest.raises(ValueError, match="d_ff"):
        GenerationServer(tlm.init_causal_lm(cfg, device="cpu"), cfg,
                         tp_shards=4, device="cpu",
                         buckets=BucketSpec(batch=(1,), length=(8,)))
    with pytest.raises(ValueError, match="tp_collectives"):
        JServer({k: jnp.asarray(v) for k, v in LOUD.items()}, CFG,
                tp_shards=2, tp_collectives="bf16",
                buckets=JBucketSpec(batch=(1,), length=(8,)))


def test_world_of_one_healthz_reports_tp_keys():
    srv = _make()
    h = srv.healthz()
    assert h["tp_shards"] == 1 and h["tp_collectives"] == "f32"


@pytest.mark.gpu
def test_paged_kernel_on_one_ranks_heads_matches_plain():
    """On the card: the paged kernel at the serving shape's local heads
    (8 heads over tp=2: 4 a rank) against its plain version on one
    rank's pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    gen = torch.Generator().manual_seed(0)
    slots, heads, d, n_pages, page, pps = 64, 4, 64, 512, 64, 3
    q = torch.randn(slots, heads, d, generator=gen).cuda()
    kp = torch.randn(n_pages, page, heads, d, generator=gen).cuda()
    vp = torch.randn(n_pages, page, heads, d, generator=gen).cuda()
    tables = torch.randint(1, n_pages, (slots, pps), generator=gen,
                           dtype=torch.int32).cuda()
    lens = torch.randint(0, pps * page + 1, (slots,), generator=gen,
                         dtype=torch.int32).cuda()
    got = paged_decode_attention(q, kp, vp, tables, lens)
    want = paged_decode_attention_reference(q, kp, vp, tables, lens)
    live = lens > 0
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)
