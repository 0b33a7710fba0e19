"""The port's chaos harness (``python -m mxnet_tpu_torch.tools.chaos_check``)
on the CPU: the modes ``train``, ``serve``, ``fleet``, ``llm``, ``slo``
and ``obs`` (``elastic`` and ``ckpt``: ``test_torch_chaos_supervised.
py``), each run with ``--device cpu`` in a process of its own as a user
runs it, must exit 0 with its PASS line — with ``jax`` and
``mxnet_tpu`` unimportable in every process the mode starts (the llm
mode's tensor-parallel gang, its journal child).  Beside that:

- the ``train`` mode's reference trajectory is the JAX package's for
  the same loop from the same parameters (copied by name), within 1e-5;
- the ``llm`` mode's greedy tokens (the salvage leg's oracle at
  temperature 0) are the JAX server's for the same parameters;
- a mode whose fault is disarmed fails, and the llm tp leg fails when
  its SIGTERM finds nothing in flight: the harness can fail;
- without a card the default ``--device cuda`` raises and runs nothing.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu_torch import fault
from mxnet_tpu_torch.tools import chaos_check as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("train", "serve", "fleet", "llm", "slo", "obs")
TIMEOUT = 240


def poisoned_env(root):
    """The env of a mode's process: the repo on the path behind a
    directory whose ``jax`` and ``mxnet_tpu`` raise on import."""
    poison = os.path.join(root, "poison")
    for name in ("jax", "mxnet_tpu"):
        os.makedirs(os.path.join(poison, name), exist_ok=True)
        with open(os.path.join(poison, name, "__init__.py"), "w") as f:
            f.write(f"raise ImportError('{name} imported by a chaos "
                    f"process')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [poison, REPO] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.pop("XLA_FLAGS", None)
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


def start_mode(mode, root, env):
    log = open(os.path.join(root, f"{mode}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_check",
         "--mode", mode, "--device", "cpu"], stdout=log,
        stderr=subprocess.STDOUT, env=env, cwd=root, start_new_session=True)
    proc.log = log
    return proc


def finish_mode(proc, mode, root, timeout=TIMEOUT):
    """The mode's exit code and output; a mode past ``timeout`` is
    killed with every process it started."""
    import signal
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    proc.log.close()
    return rc, open(os.path.join(root, f"{mode}.log")).read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mode's (exit code, output): ``slo`` and ``obs`` first, each
    alone (their contracts read tail latencies, an abuser's rate and a
    guard's nanoseconds against a request's), then the llm mode (a gang
    and a child process) beside the others, which run one after
    another."""
    root = str(tmp_path_factory.mktemp("chaos"))
    env = poisoned_env(root)
    out = {m: finish_mode(start_mode(m, root, env), m, root)
           for m in ("slo", "obs")}
    llm = start_mode("llm", root, env)
    try:
        for mode in MODES:
            if mode not in out and mode != "llm":
                out[mode] = finish_mode(start_mode(mode, root, env), mode,
                                        root)
    finally:
        out["llm"] = finish_mode(llm, "llm", root)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_mode_passes_on_the_cpu(runs, mode):
    rc, text = runs[mode]
    assert rc == 0, text[-4000:]
    assert "[chaos_check] PASS: " in text
    assert "FAIL" not in text
    # the host runs the plain versions: no hand-written kernel launched
    assert "[chaos_check] launches {}" in text
    assert "imported by a chaos process" not in text


def test_llm_mode_ran_its_tp_gang_and_legs(runs):
    _, text = runs["llm"]
    assert "[r0] [chaos_check] llm: accepted=" in text
    assert "over tp_shards=2 (int8 decode collectives)" in text
    assert "the tp=2 gang exited 0" in text
    for leg in ("llm spec leg: accepted=", "storm served 4/4",
                "journal_restores=2 restored=2"):
        assert leg in text, leg


def test_list_modes_names_the_ported_modes_and_the_rest():
    out = subprocess.run([sys.executable, "-m",
                          "mxnet_tpu_torch.tools.chaos_check",
                          "--list-modes"], capture_output=True, text=True,
                         timeout=60, cwd=REPO)
    assert out.returncode == 0
    names = [ln.split()[0] for ln in out.stdout.splitlines()
             if not ln.startswith("(")]
    assert names == ["train", "serve", "fleet", "llm", "elastic", "slo",
                     "obs", "ckpt"]
    assert "lint, cost, hlo" in out.stdout and "A18" in out.stdout


def test_device_cuda_without_a_card_raises(tmp_path):
    proc = subprocess.run([sys.executable, "-m",
                           "mxnet_tpu_torch.tools.chaos_check", "--mode",
                           "serve"], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=poisoned_env(
                              str(tmp_path)))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "PASS" not in proc.stdout and "serve:" not in proc.stdout


# ---------------------------------------------------- against the JAX side --
def _layer_params(net):
    """``{(layer index, weight|bias): numpy}`` of a Sequential of Dense."""
    out = {}
    for i, blk in enumerate(net._children.values()):
        for name, p in blk.collect_params().items():
            out[(i, name.rsplit("_", 1)[1])] = p
    return out


def test_train_reference_trajectory_is_jaxs():
    """The mode's uninterrupted run (its net, TrainStep, batches) against
    the same loop in the JAX package from the same parameters."""
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgluon, parallel as jparallel
    from mxnet_tpu.gluon import nn as jnn

    net = cc.dense_net(7, "cpu")
    batches = cc.train_batches(8)
    port = cc.reference_run(cc.dense_step(net), batches)

    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, activation="relu", in_units=8),
             jnn.Dense(4, in_units=16))
    jnet.initialize()
    net = cc.dense_net(7, "cpu")           # the same seed: the same init
    src = _layer_params(net)
    dst = _layer_params(jnet)
    assert sorted(src) == sorted(dst) == [(0, "bias"), (0, "weight"),
                                          (1, "bias"), (1, "weight")]
    for k, p in dst.items():
        p.set_data(jmx.nd.array(src[k].data().asnumpy()))
    step = jparallel.TrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                               jmx.optimizer.create("adam"))
    jax_side = [float(step(x, y).asnumpy()) for x, y in batches]
    np.testing.assert_allclose(port, jax_side, rtol=1e-5, atol=1e-5)
    assert port[-1] < port[0]


def test_llm_greedy_tokens_are_the_jax_servers():
    """The salvage leg's oracle, the llm mode's tp=1 server, from the
    JAX tool's parameters (``init_causal_lm(cfg, seed=0)``): its greedy
    streams (the prompts without a temperature) are the JAX server's."""
    import jax.numpy as jnp
    from mxnet_tpu import serving as jserving
    from mxnet_tpu.gluon.model_zoo import causal_lm as jlm
    from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm

    jcfg = jlm.CausalLMConfig(**cc.SMALL_LM)
    jparams = {k: np.asarray(v, np.float32)
               for k, v in jlm.init_causal_lm(jcfg, seed=0).items()}
    port = cc.salvage_oracle(tlm.params_from_jax(jparams, device="cpu"),
                             tlm.CausalLMConfig(**cc.SMALL_LM), "cpu")
    srv = jserving.GenerationServer(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jcfg,
        buckets=jserving.BucketSpec(batch=(1,), length=(8,)), n_slots=2,
        n_pages=33, page_size=4, max_new_tokens=10, seed=0,
        name="JChaosOracle").start()
    try:
        for i, (p, kw) in enumerate(zip(cc.SALVAGE_PROMPTS,
                                        cc.SALVAGE_KINDS)):
            if kw:
                continue                       # sampled: the RNGs differ
            got = tuple(int(t) for t in srv.submit(
                np.asarray(p, np.int32), seed=cc.SALVAGE_SEEDS[i])
                .result(120))
            assert port[i] == got, (i, port[i], got)
            assert len(got) == 10
    finally:
        assert srv.drain(60)


class _Disarmed:
    """``fault.inject`` that arms nothing."""

    def __init__(self, *args, **kw):
        self.fired = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_mode_with_its_fault_disarmed_fails(monkeypatch, capsys):
    monkeypatch.setattr(fault, "inject", _Disarmed)
    args = argparse.Namespace(device="cpu", steps=8, every=2, keep=2,
                              crash_after=None)
    assert cc.train_mode(args) == 1
    assert "FAIL: injected crash never fired" in capsys.readouterr().out


def test_llm_tp_leg_fails_when_the_sigterm_finds_nothing_in_flight(capfd):
    """Traffic that is all served before the SIGTERM (four requests of
    one decode step each): the drain has nothing to drain, and the leg
    says so instead of passing."""
    args = argparse.Namespace(device="cpu", requests=25, launches={})
    leg = dict(cc.SMALL_TP, requests=1, new_tokens=(2, 3))
    fails = cc._llm_tp_leg(args, leg, timeout=TIMEOUT)
    assert any("no accepted sequence in flight" in f for f in fails), fails
    assert "at the SIGTERM 0 in flight" in capfd.readouterr().out
