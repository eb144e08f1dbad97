#!/usr/bin/env python
"""Multi-device scaling benchmark for the headline RFI flagger.

Scaling efficiency of the sharded flagger (baseline/pol sharding,
collective noise/percentile reductions) over every device JAX sees — four
NVLink-joined cards on one host, or several hosts under ``--multihost``.
On the CPU it smoke-runs on a virtual-device mesh (the numbers mean
nothing there; the point is that the program compiles, shards, and the
efficiency arithmetic is exercised end to end).

Weak-scaling protocol (the production regime — each chip owns a fixed
slice of baselines×pols over the full band):

1. time the sharded flagger over all N mesh devices on the full dump;
2. time the SAME engine on a 1-device mesh over a 1/N slice (same
   per-device work) in the same process;
3. efficiency = t_1device / t_Ndevices (1.0 = perfect; communication,
   dispatch skew, and any replicated work show up as < 1).

Both timings are medians of ``block_until_ready`` windows after a warm-up
(:func:`katsdpsigproc_tpu.utils.profiling.time_fn`).  The flagger is
``parallel.flagger.make_sharded_flagger`` over a (baseline × channel)
mesh: ``--channel-shards`` > 1 makes the halo exchanges and the psummed
collective rank search real.

Multi-host launch: run one copy of this script per host under
`parallel.multihost.initialize` (--multihost), exactly as the
`tests/multihost_worker.py` parity test does.

Prints one JSON line:
  {"metric": "multichip_scaling_efficiency", ...,
   "n_devices": N, "per_chip_vis_per_second": ..., "value": efficiency}
"""

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--channels", type=int, default=32768)
    ap.add_argument("--baselines", type=int, default=2016,
                    help="TOTAL baseline rows (after pol flattening); "
                         "rounded up to divide the mesh")
    ap.add_argument("--pols", type=int, default=1)
    ap.add_argument("--width", type=int, default=13)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--channel-shards", type=int, default=1,
                    help="channel-axis mesh extent (makes the halo exchange + "
                         "collective rank search real)")
    ap.add_argument("--multihost", action="store_true",
                    help="call parallel.multihost.initialize() first; pass "
                         "--coordinator/--num-processes/--process-id")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address (host:port) for --multihost")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    # CPU smoke runs want the virtual multi-device mesh; the backend reads
    # XLA_FLAGS at its first use, which has not happened yet.
    if os.environ.get("KATSDPSIGPROC_TPU_PLATFORM") == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    from katsdpsigproc_tpu.parallel import (
        flagger as pflagger,
        mesh as pmesh,
        multihost,
    )
    from katsdpsigproc_tpu.utils import backend
    from katsdpsigproc_tpu.utils.profiling import time_fn

    backend.apply_platform_env()
    backend.enable_compile_cache()

    if args.multihost:
        multihost.initialize(args.coordinator, args.num_processes, args.process_id)
        log(multihost.process_summary())

    n = jax.device_count()
    dev = jax.devices()[0]
    if n % args.channel_shards:
        raise SystemExit(f"--channel-shards {args.channel_shards} must divide {n}")
    rows = args.baselines * args.pols
    unit = n // args.channel_shards
    rows = -(-rows // unit) * unit
    log(f"{n} devices ({dev.device_kind}); dump {rows} rows x {args.channels} channels")

    rs = np.random.RandomState(seed=1)
    # channel-major (C, B, 2) planar float32
    vis_np = rs.standard_normal((args.channels, rows, 2)).astype(np.float32)
    n_vis = rows * args.channels

    def spec_for(mesh):
        channel = pmesh.CHANNEL_AXIS if pmesh.CHANNEL_AXIS in mesh.axis_names else None
        return jax.sharding.PartitionSpec(channel, pmesh.BASELINE_AXIS, None)

    def make_fn(mesh):
        return pflagger.make_sharded_flagger(mesh, width=args.width, n_sigma=11.0,
                                             threshold="sum")

    # N-device mesh.  Cross-process-safe placement: every process passes
    # the full replicated host array (device_put rejects multi-process
    # shardings).
    mesh_n = pmesh.make_mesh((n // args.channel_shards, args.channel_shards),
                             (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))
    fn_n = make_fn(mesh_n)
    vis_n = pmesh.shard_with_spec(mesh_n, vis_np, spec_for(mesh_n))
    t_n = time_fn(lambda: fn_n(vis_n), iters=args.iters)

    # 1-device control leg: the same per-device work (1/N of the rows).
    # Each process times its own LOCAL device — a global 1-device mesh
    # would be non-addressable from the other processes.
    mesh_1 = pmesh.make_mesh((1,), (pmesh.BASELINE_AXIS,), devices=jax.local_devices()[:1])
    fn_1 = make_fn(mesh_1)
    vis_1 = pmesh.shard_with_spec(mesh_1, vis_np[:, : rows // n], spec_for(mesh_1))
    t_1 = time_fn(lambda: fn_1(vis_1), iters=args.iters)

    eff = t_1 / t_n
    per_chip = n_vis / t_n / n
    log(f"N={n}: {t_n * 1e3:.3f} ms/dump ({n_vis / t_n / 1e9:.2f} Gvis/s aggregate, "
        f"{per_chip / 1e9:.2f} Gvis/s/device); 1-device 1/N slice: {t_1 * 1e3:.3f} ms; "
        f"weak-scaling efficiency {eff * 100:.1f}%")
    # One JSON stream per job: only the coordinator process emits the record
    # (every process computed the same global timings).
    if jax.process_index() == 0:
        print(json.dumps({
            "metric": "multichip_scaling_efficiency",
            "value": eff,
            "unit": "fraction",
            "vs_baseline": eff / 0.85,  # BASELINE.md: >=0.85
            "n_devices": n,
            "n_hosts": jax.process_count(),
            "channel_shards": args.channel_shards,
            "seconds_per_dump": t_n,
            "aggregate_vis_per_second": n_vis / t_n,
            "per_chip_vis_per_second": per_chip,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": n,
        }))


if __name__ == "__main__":
    main()
