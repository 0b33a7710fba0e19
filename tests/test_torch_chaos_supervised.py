"""The port's chaos harness, the modes that supervise processes of their
own, on the CPU: ``elastic`` (an ``elastic.Supervisor`` gang of two
``python -m mxnet_tpu_torch.elastic_worker`` processes, SIGKILLed,
SIGSTOPped and SIGTERMed) and ``ckpt`` (a snapshot storm in a child
process killed with SIGKILL three times, a bit-flipped snapshot, a live
updater under ``keep_last=1``).  Both run at once, each with
``--device cpu`` in a session of its own (killed whole past its time
limit), with ``jax`` and ``mxnet_tpu`` unimportable in every process
they start; each must exit 0 with its PASS line.
"""
import pytest

from test_torch_chaos import finish_mode, poisoned_env, start_mode

MODES = ("elastic", "ckpt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chaos_supervised"))
    env = poisoned_env(root)
    procs = {m: start_mode(m, root, env) for m in MODES}
    return {m: finish_mode(p, m, root) for m, p in procs.items()}


@pytest.mark.parametrize("mode", MODES)
def test_mode_passes_on_the_cpu(runs, mode):
    rc, text = runs[mode]
    assert rc == 0, text[-4000:]
    assert "[chaos_check] PASS: " in text
    assert "FAIL" not in text
    assert "imported by a chaos process" not in text


def test_elastic_mode_restarted_twice_and_resumed_forward(runs):
    _, text = runs["elastic"]
    assert "SIGKILLed rank 1 mid-run" in text
    assert "SIGSTOPed rank 0 (watchdog bait)" in text
    assert "recovered within budget (2 restarts" in text
    assert "drained to ['preempted', 'preempted']" in text


def test_ckpt_mode_killed_three_storms(runs):
    _, text = runs["ckpt"]
    for r in range(3):
        assert f"ckpt: kill round {r}: " in text
    assert "bit-flip rejected everywhere" in text
