"""The coordinator port of a gang started through the port's launcher
(``python -m mxnet_tpu_torch.launch``): the launcher chooses it by
binding a listening socket and hands that socket to rank 0, whose
``TCPStore`` serves on it (``elastic.STORE_FD_ENV``), so the port is
never free between being chosen and being served.

A port that was chosen, released and bound again later could be taken
in between — by another gang's store or by one of the listeners gloo
binds — and then rank 0 could not serve its store, and rank 1 could
join a stranger's.  Held here: while rank 0 has not yet joined, the
port is already taken (a competitor's bind fails); and two gangs
started at once each gather only their own ranks' tokens.

And a rank that joined leaves the group at exit (``distributed``'s
``atexit`` hook): left to the interpreter's teardown, rank 0's store
thread could be destroyed unjoined and abort the process after its work
("terminate called without an active exception"), failing the gang.

Each gang runs this file as its worker script: a rank writes its
coordinator port, waits for the test's go, then joins the group by
importing the package and gathers one token a rank; at exit it notes
whether the group was already left.
"""
import atexit
import os
import socket
import sys
import time

import numpy as np


def note_left(outdir, rank):
    """Registered before the rank joins, so it runs after the package's
    exit hook (``atexit`` runs last in, first out)."""
    from mxnet_tpu_torch import distributed

    with open(os.path.join(outdir, f"left{rank}"), "w") as f:
        f.write("joined" if distributed.is_initialized() else "left")


def worker(outdir, tag):
    rank = int(os.environ["DMLC_WORKER_ID"])
    atexit.register(note_left, outdir, rank)
    with open(os.path.join(outdir, f"port{rank}"), "w") as f:
        f.write(os.environ["DMLC_PS_ROOT_PORT"])
    deadline = time.monotonic() + 120
    while not os.path.exists(os.path.join(outdir, "go")):
        if time.monotonic() > deadline:
            raise SystemExit("no go from the test")
        time.sleep(0.02)
    from mxnet_tpu_torch import distributed      # joins the gang

    got = distributed.all_gather(np.array([int(tag) + rank], np.int64))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             tokens=np.asarray(got).reshape(-1),
             backend=np.array(distributed.backend()))
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
    sys.exit(0)


from test_torch_dp_step import finish_gang, kill_gang, start_gang  # noqa: E402


def _port(outdir, timeout=120):
    path = os.path.join(outdir, "port0")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            text = open(path).read()
            if text:
                return int(text)
        time.sleep(0.02)
    raise AssertionError("rank 0 never wrote its coordinator port")


def _go(outdir):
    open(os.path.join(outdir, "go"), "w").close()


def test_store_port_is_held_before_rank0_joins(tmp_path):
    outdir = str(tmp_path)
    proc = start_gang(os.path.abspath(__file__), outdir, timeout=120,
                      extra=("100",))
    try:
        port = _port(outdir)
        competitor = socket.socket()
        try:
            try:
                competitor.bind(("127.0.0.1", port))
                taken = False
            except OSError:
                taken = True
        finally:
            competitor.close()
        assert taken, f"the coordinator port {port} was free before rank 0 " \
                      f"served its store: another process could take it"
        _go(outdir)
    except BaseException:
        kill_gang(proc)
        raise
    ranks = finish_gang(proc, outdir)
    for res in ranks:
        assert sorted(res["tokens"].tolist()) == [100, 101]
        assert str(res["backend"]) == "gloo"


def test_two_gangs_at_once_each_get_their_own_store(tmp_path):
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    procs = []
    try:
        for d, tag in zip(dirs, ("100", "200")):
            os.makedirs(d)
            procs.append(start_gang(os.path.abspath(__file__), d,
                                    timeout=120, extra=(tag,)))
        ports = [_port(d) for d in dirs]
        assert ports[0] != ports[1]
        for d in dirs:
            _go(d)
    except BaseException:
        for p in procs:
            kill_gang(p)
        raise
    for d, proc, tag in zip(dirs, procs, (100, 200)):
        for res in finish_gang(proc, d):
            assert sorted(res["tokens"].tolist()) == [tag, tag + 1]


def test_ranks_leave_the_group_at_exit(tmp_path):
    """No rank calls ``shutdown()``: the package's exit hook leaves."""
    outdir = str(tmp_path)
    proc = start_gang(os.path.abspath(__file__), outdir, timeout=120,
                      extra=("300",))
    try:
        _port(outdir)
        _go(outdir)
    except BaseException:
        kill_gang(proc)
        raise
    finish_gang(proc, outdir)
    for rank in range(2):
        assert open(os.path.join(outdir, f"left{rank}")).read() == "left"
