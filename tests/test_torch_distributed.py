"""``mxnet_tpu_torch.distributed`` against the JAX package's
``distributed``, on the CPU.

- ``init()`` with no env is a no-op world of one, and the collectives
  are the identity there (``tests/test_distributed.py``'s
  ``test_single_process_init_noop``, through both packages);
- ``init``'s argument errors word for word; a bounded ``barrier`` in a
  configured gang without a process group raises as the JAX one does;
- the backend rule (``_pick_backend``): NCCL only when every rank has a
  card of its own, gloo when ranks share a card or have none;
- in-process: ``init`` with a coordinator and a world of one joins a
  gloo group of one, retrying through an armed ``distributed.connect``
  fault; ``barrier``, the collectives, ``shutdown`` and a second
  ``init`` after it;
- a gang of two through the port's launcher (``tests/
  test_distributed.py``'s localhost rehearsal): the second attempt of a
  gang whose rank 1 died on the first joins and sums across both ranks;
  and ``examples/dist_train.py`` as written, with the port as ``mx``,
  both ranks printing the same weight checksum.
"""
import os
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RESTART_WORKER = """
import os, sys
attempt = int(os.environ.get("DMLC_ATTEMPT", "0"))
rank = os.environ["DMLC_WORKER_ID"]
if attempt == 0 and rank == "1":
    sys.exit(3)  # a worker lost on the first attempt
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import distributed
distributed.init()
s = distributed.all_sum(np.ones((2,), np.float32))
assert float(np.asarray(s)[0]) == distributed.num_workers() == 2
assert distributed.backend() == "gloo"
print(f"attempt {attempt} rank {rank} OK", flush=True)
"""


def example_worker():
    """``examples/dist_train.py`` run as written, with the port loaded
    as ``mxnet_tpu`` and the CPU as the default context."""
    import runpy

    import mxnet_tpu_torch as mx
    for name, mod in list(sys.modules.items()):
        if name == "mxnet_tpu_torch" or name.startswith("mxnet_tpu_torch."):
            sys.modules["mxnet_tpu" + name[len("mxnet_tpu_torch"):]] = mod
    with mx.cpu():
        runpy.run_path(os.path.join(REPO, "examples", "dist_train.py"),
                       run_name="__main__")


if __name__ == "__main__":
    example_worker()
    sys.exit(0)


import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu_torch import distributed, fault  # noqa: E402


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env.setdefault("OMP_NUM_THREADS", "2")     # the ranks share the cores
    return env


def _launch(args, timeout=240):
    """The launcher with ``args``, in a session of its own: on a timeout
    its whole process group (the ranks too) is killed, then the timeout
    raises."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", *args],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_single_process_init_noop():
    for pkg in (jmx, __import__("mxnet_tpu_torch")):
        pkg.distributed.init()
        assert pkg.distributed.num_workers() == 1
        assert pkg.distributed.rank() == 0
        s = pkg.distributed.all_sum(np.ones((2,), np.float32))
        np.testing.assert_allclose(np.asarray(s), np.ones((2,)))
        g = pkg.distributed.all_gather(np.ones((2,), np.float32))
        assert np.asarray(g).shape == (1, 2)
        b = pkg.distributed.broadcast(np.arange(3, dtype=np.float32))
        np.testing.assert_array_equal(np.asarray(b), np.arange(3))
        pkg.distributed.barrier()
        pkg.distributed.shutdown()
    assert distributed.backend() is None and not distributed.is_initialized()


def test_init_argument_errors_match_jax():
    for kw in (dict(coordinator="localhost:1", num_processes=2,
                    process_id=2),
               dict(coordinator="localhost:1", num_processes=3,
                    process_id=-1)):
        with pytest.raises(ValueError) as je:
            jmx.distributed.init(**kw)
        with pytest.raises(ValueError) as te:
            distributed.init(**kw)
        assert str(je.value) == str(te.value)


def test_bounded_barrier_without_a_group_in_a_gang(monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.barrier("b", timeout=1)
    distributed.barrier("b")               # unbounded: a no-op
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    distributed.barrier("b", timeout=1)


class _Store:
    def __init__(self, preset):
        self.d = {f"mxtpu:card:{distributed._epoch}:{r}": v.encode()
                  for r, v in preset.items()}

    def set(self, k, v):
        self.d[k] = v.encode()

    def get(self, k):
        return self.d[k]


@pytest.mark.parametrize("cards,backend", [
    (["cpu", "cpu"], "gloo"),
    (["h:GPU-a", "h:GPU-b"], "nccl"),
    (["h:GPU-a", "h:GPU-a"], "gloo"),
    (["h:GPU-a", "h:GPU-b", "h:GPU-a"], "gloo"),
    (["h:GPU-a"], "nccl"),
])
def test_backend_rule(cards, backend):
    import torch
    store = _Store({r: c for r, c in enumerate(cards) if r})
    chosen, seen = distributed._pick_backend(
        store, 0, len(cards), torch.device("cpu"))
    if cards[0] == "cpu":
        assert chosen == backend and seen == cards
        return
    # rank 0's own card comes from the device; stand its identity in
    orig = distributed._card_identity
    distributed._card_identity = lambda index: cards[0]
    try:
        chosen, seen = distributed._pick_backend(
            store, 0, len(cards), torch.device("cuda", 0))
    finally:
        distributed._card_identity = orig
    assert (chosen, seen) == (backend, cards)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_world_of_one_retries_and_reinits():
    import torch
    from mxnet_tpu_torch import parallel
    try:
        with fault.inject("distributed.connect",
                          ConnectionError("coordinator not up"),
                          times=1) as h:
            distributed.init(coordinator=f"127.0.0.1:{_free_port()}",
                             num_processes=1, process_id=0,
                             backoff_base=0.01, timeout=60)
        assert h.fired == 1
        assert distributed.is_initialized()
        assert distributed.backend() == "gloo"
        assert distributed.device() == torch.device("cpu")
        assert (distributed.rank(), distributed.num_workers()) == (0, 1)
        distributed.barrier()
        distributed.barrier("x", timeout=5)
        np.testing.assert_array_equal(
            distributed.all_sum(np.arange(3, dtype=np.float32)).numpy(),
            np.arange(3))
        mesh = parallel.make_mesh()
        assert mesh.group("dp") is torch.distributed.group.WORLD
        with parallel.MeshScope(mesh):
            assert torch.equal(parallel.mesh.psum(torch.ones(2), "dp"),
                               torch.ones(2))
        distributed.shutdown()
        assert not distributed.is_initialized()
        distributed.init(coordinator=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, timeout=60)
        assert distributed.num_workers() == 1 and distributed.is_initialized()
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


def test_gang_restart_rejoins_and_sums(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(RESTART_WORKER)
    proc = _launch(["-n", "2", "--platform", "cpu", "--max-restarts", "2",
                    "--backoff-base", "0.05", sys.executable, str(script)])
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "restart 1/2" in proc.stderr
    assert "attempt 1 rank 0 OK" in proc.stdout
    assert "attempt 1 rank 1 OK" in proc.stdout


def test_dist_train_example_on_two_ranks():
    proc = _launch(["-n", "2", "--platform", "cpu", sys.executable,
                    os.path.abspath(__file__)])
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    sums = {}
    for r in range(2):
        assert f"worker {r}/2 up" in proc.stdout
        m = re.search(rf"worker {r} done; weight checksum=(\S+)",
                      proc.stdout)
        assert m, proc.stdout[-2000:]
        sums[r] = float(m.group(1))
    assert sums[0] == sums[1]
    losses = [float(x) for x in re.findall(r"worker 0 step \d+: loss=(\S+)",
                                           proc.stdout)]
    assert len(losses) == 4 and losses[-1] < losses[0]
