"""KVStore bandwidth microbenchmark.

ref: tools/bandwidth/measure.py — measures the push/pull throughput of a
kvstore over a range of array sizes; used to size gradient-aggregation
traffic::

    python -m mxnet_tpu_torch.tools.bandwidth [--kvstore device] \\
        [--sizes 1e5,1e6,1e7] [--repeat 10] [--json] [--device cuda]
    python -m mxnet_tpu_torch.launch -n 2 \\
        python -m mxnet_tpu_torch.tools.bandwidth --kvstore dist_sync

The arrays live on the card (``--device cuda``, the default; it raises
without one, and under a gang each rank takes its own card, or the
card it shares); ``--device cpu`` measures the host.  Under the
launcher the process joins the gang's group at import, so a ``dist_*``
store merges every push over the gang (an all-reduce through
``mxnet_tpu_torch.distributed``: NCCL when each rank has a card of its
own, gloo otherwise); ``launch -n 1`` makes the world of one's group.

Each row checks itself before it reports a rate: the values are
integers (exact in float32), so the pull after every push must equal,
bit for bit, the sum that push makes (over the gang for a ``dist_*``
store).  A row that disagrees raises.  Each push chains on the last
pull: the pull divided by the world (exact: the quotient is the last
push, an integer) plus one, so the values stay small at any world
size and repeat count.  Rank 0 prints a ``#`` line (the
store, the device, the process group) and the rows.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _device(name):
    """The sweep's device: the rank's card under a gang, else ``name``
    (``cuda`` raises without a card)."""
    from .. import distributed
    from ..context import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda" and distributed.is_initialized():
        return distributed.device()
    return dev


def _merge_factor(kv):
    """How many equal pushes one push merges: the world for a dist
    store, else 1."""
    return kv.num_workers if kv.type.startswith("dist_") else 1


def measure(kv_type="device", sizes=(100_000, 1_000_000, 10_000_000),
            repeat=10, emit_json=False, device="cuda"):
    """The sweep: one row a size, ``{"size", "bytes",
    "avg_roundtrip_ms", "GB_per_s"}`` (push + pull bytes over the mean
    round trip), as the reference's rows."""
    import torch

    import mxnet_tpu_torch as mx
    from ..context import context_of

    dev = _device(device)
    kv = mx.kv.create(kv_type)
    world = _merge_factor(kv)

    def chained(out):
        # the last push + 1, from the pull: each push depends on the
        # previous pull, so no iteration can be served from a cached or
        # idempotent result
        return (out / world if world > 1 else out) + 1.0

    results = []
    with context_of(dev):
        for n in sizes:
            n = int(n)
            key = f"bw_{n}"
            want = np.random.RandomState(0).randint(
                -8, 9, size=n).astype(np.float64)
            grad = mx.nd.array(want.astype(np.float32))
            kv.init(key, mx.nd.zeros((n,)))
            out = mx.nd.zeros((n,))
            kv.push(key, grad)
            kv.pull(key, out=out)
            want = want * world
            _check(out, want, key, "the first pull")
            kv.push(key, chained(out))  # warm the timed loop's ops too
            kv.pull(key, out=out)
            want = (want / world + 1.0) * world
            final = (want / world + repeat) * world
            t0 = time.perf_counter()
            for _ in range(repeat):
                kv.push(key, chained(out))
                kv.pull(key, out=out)
            out.wait_to_read()
            mx.engine.waitall()
            dt = (time.perf_counter() - t0) / repeat
            _check(out, final, key, f"the pull after {repeat} round trips")
            nbytes = n * 4
            gbps = 2 * nbytes / dt / 1e9  # push + pull
            results.append({"size": n, "bytes": nbytes,
                            "avg_roundtrip_ms": round(dt * 1e3, 3),
                            "GB_per_s": round(gbps, 3)})
            del grad, out
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if kv.rank == 0:
        from .. import distributed
        group = (f"world {distributed.num_workers()} over "
                 f"{distributed.backend()}" if distributed.is_initialized()
                 else "no process group")
        print(f"# kvstore {kv_type} on {dev}, {group}", flush=True)
        for r in results:
            if emit_json:
                print(json.dumps(r), flush=True)
            else:
                print(f"size {r['size']:>12,}  {r['avg_roundtrip_ms']:>10.3f}"
                      f" ms  {r['GB_per_s']:>8.3f} GB/s", flush=True)
    return results


def _check(out, want, key, what):
    """``out`` must hold ``want`` exactly (integers below 2**24)."""
    got = out.asnumpy().astype(np.float64)
    bad = np.flatnonzero(got != want)
    if bad.size:
        i = int(bad[0])
        raise AssertionError(
            f"{key}: {what} disagrees with the pushed sum at {bad.size} of "
            f"{want.size} elements (first [{i}]: {got[i]} != {want[i]})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kvstore", default="device")
    ap.add_argument("--sizes", default="1e5,1e6,1e7")
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    sizes = [int(float(s)) for s in args.sizes.split(",")]
    from .. import distributed
    distributed.init()      # the launcher's gang, a world of one included
    try:
        measure(args.kvstore, sizes, args.repeat, args.json, args.device)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
