"""Elastic multi-process launcher of the port (the counterpart of
``tools/launch.py``): a thin CLI over ``elastic.Supervisor``.

    python -m mxnet_tpu_torch.launch -n 1 --platform gpu \\
        --devices-per-worker 1 --max-restarts 3 --progress-dir ckpts \\
        --event-log events.jsonl \\
        python -m mxnet_tpu_torch.elastic_worker --device cuda \\
            --net resnet50_fused --target-step 10 --ckpt-dir ckpts --every 2

It exports the DMLC_* env contract and ``MXTPU_HEARTBEAT_DIR`` to
``-n`` copies of the command, watches their heartbeats
(``--watchdog-secs``), tears the whole gang down on any failure (SIGTERM
so healthy workers snapshot, SIGKILL after ``--graceful-secs``) and
relaunches it with backoff; ``--max-restarts`` refills whenever an
attempt advanced the committed checkpoint step under ``--progress-dir``.
Worker output is prefixed ``[r<rank>]`` (or teed to per-rank files
under ``--log-dir``); every transition lands in ``--event-log``.

``--platform`` places the workers through ``CUDA_VISIBLE_DEVICES``:
``cpu`` hides every card, ``gpu`` with ``--devices-per-worker d`` shows
rank r the cards r*d .. r*d+d-1 (the JAX launcher sets
``JAX_PLATFORMS`` and XLA's host device count instead).

Run it as a module of the package: the launcher imports the package
(and so torch) but initialises no card, and shares the package's
``fault`` points with the supervisor.
"""
import argparse
import sys

from . import elastic


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("--platform", choices=["cpu", "gpu"], default=None,
                   help="cpu: workers see no card; gpu: with "
                        "--devices-per-worker, each rank its own cards "
                        "(CUDA_VISIBLE_DEVICES)")
    p.add_argument("--devices-per-worker", type=int, default=0,
                   help="with --platform gpu: cards per worker")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="on any failure tear the gang down and relaunch "
                        "up to N times; with --progress-dir the budget "
                        "refills whenever an attempt advanced the "
                        "committed checkpoint step")
    p.add_argument("--watchdog-secs", type=float, default=0.0,
                   help="declare a worker hung when its heartbeat goes "
                        "stale this long (0 = no watchdog)")
    p.add_argument("--startup-grace-secs", type=float, default=None,
                   help="also declare a hang when a worker produced no "
                        "heartbeat this long after spawn; default with a "
                        "watchdog armed: 10x --watchdog-secs, min 60s")
    p.add_argument("--graceful-secs", type=float, default=10.0,
                   help="SIGTERM→SIGKILL escalation window on teardown "
                        "(size it to cover one step + one snapshot)")
    p.add_argument("--backoff-base", type=float, default=0.5,
                   help="base delay of the exponential restart backoff")
    p.add_argument("--heartbeat-dir", default=None,
                   help="where workers stamp heartbeats (default: a "
                        "fresh temp dir, exported as MXTPU_HEARTBEAT_DIR)")
    p.add_argument("--progress-dir", default=None,
                   help="CheckpointManager directory to read committed "
                        "progress from")
    p.add_argument("--progress-prefix", default="ckpt",
                   help="checkpoint filename prefix under --progress-dir")
    p.add_argument("--log-dir", default=None,
                   help="tee each worker's output to r<rank>.log here")
    p.add_argument("--event-log", default=None,
                   help="append supervision events as JSONL here")
    p.add_argument("--no-prefix", action="store_true",
                   help="pass worker output through untagged")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command given")

    sup = elastic.Supervisor(
        args.command, args.num_workers,
        platform=args.platform,
        devices_per_worker=args.devices_per_worker,
        max_restarts=args.max_restarts,
        watchdog_secs=args.watchdog_secs,
        startup_grace_secs=args.startup_grace_secs,
        graceful_secs=args.graceful_secs,
        backoff_base=args.backoff_base,
        heartbeat_dir=args.heartbeat_dir,
        log_dir=args.log_dir,
        event_log=args.event_log,
        progress_dir=args.progress_dir,
        progress_prefix=args.progress_prefix,
        prefix_output=not args.no_prefix)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
