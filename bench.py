#!/usr/bin/env python
"""Benchmark of the RFI flagger and its primitives on one NVIDIA GPU.

Prints ONE JSON line per benchmark on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N, ...}
Diagnostics go to stderr.

The headline (config 5, the default) is visibilities flagged per second on
the full pipeline (background median filter width 13 → MAD noise →
4-window SumThreshold) at 2016 baselines × 4 pols × 32768 channels — the
4-pol MeerKAT dump, flattened to 8064 independent rows of planar float32 —
through ``make_flagger_fn`` blocked in slabs of 288 baselines, plus a 1-pol
side record at 2016 rows.  ``vs_baseline`` is the achieved fraction of the
BASELINE.md target, 80% of the device-memory roofline for the pipeline's
minimum traffic (8 B/vis read + 1 B/vis flag write) at the card's published
peak bandwidth (:data:`PEAK_HBM_GBPS`).  Configs 1-4 time the other
BASELINE.json workloads (``--config``).

Mask parity against the host oracle is checked on complete baselines
before timing.  Times are the median (and spread) of ``block_until_ready``
windows after a warm-up (:func:`katsdpsigproc_tpu.utils.profiling.
time_samples`).  A device missing from the peak table is an error: there
is no CPU fallback.
"""

import argparse
import json
import sys

import numpy as np

#: Published peak device-memory bandwidth in GB/s, by JAX ``device_kind``.
#: Source: NVIDIA H100 Tensor Core GPU datasheet (SXM5, 80 GB HBM3: 3.35 TB/s).
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}
BYTES_PER_VIS = 8 + 1  # complex64 read + uint8 flag write
TARGET_FRACTION = 0.8  # BASELINE.md: ≥80% of the memory roofline


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def peak_hbm_gbps(device_kind: str) -> float:
    """Peak memory bandwidth of `device_kind`; an unknown device is an error."""
    try:
        return PEAK_HBM_GBPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak bandwidth for device kind {device_kind!r}: add it to "
            f"bench.PEAK_HBM_GBPS with its source") from None


def timing(fn, *args, iters: int) -> dict:
    """Median and spread of `iters` blocking calls of ``fn(*args)``."""
    from katsdpsigproc_tpu.utils.profiling import time_samples

    samples = time_samples(lambda: fn(*args), iters=iters, warmup=2)
    q1, med, q3 = np.percentile(samples, [25, 50, 75])
    return {"seconds": float(med), "seconds_q1": float(q1), "seconds_q3": float(q3),
            "seconds_min": float(samples.min()), "seconds_max": float(samples.max()),
            "iters": iters}


def record(metric, per_second, unit, vs_baseline, t, **extra):
    return {"metric": metric, "value": per_second, "unit": unit,
            "vs_baseline": vs_baseline, **t, **extra}


def bench_config1(args, hbm_gbps):
    """BASELINE.json config 1: rfiflagtest single-baseline synthetic —
    1k channels × 3k times, 2-D MAD+SumThreshold flagger (twodflag)."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.models.rfi import twodflag

    times, channels, baselines = 3000, 1024, 1
    rs = np.random.RandomState(seed=1)
    shape = (times, channels, baselines)
    amp = np.abs(rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.float32)
    impl = twodflag.SumThresholdFlagger()._impl(shape)
    t = timing(impl, jnp.asarray(amp), jnp.zeros(shape, bool), iters=args.iters)
    n_vis = times * channels * baselines
    log(f"config1 twodflag {times}x{channels}x{baselines}: {t['seconds'] * 1e3:.3f} ms")
    # The reference's numba path: ~0.3 Mvis/s per CPU core (BASELINE.md).
    return [record("twodflag_1kx3k_visibilities_per_second", n_vis / t["seconds"], "vis/s",
                   n_vis / t["seconds"] / 0.3e6, t)]


def bench_config2(args, hbm_gbps):
    """BASELINE.json config 2: batched rank-select (percentile5) and masked
    reductions (maskedsum) over 64 baselines × 4k channels."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import maskedsum as ms, percentile as pct
    from katsdpsigproc_tpu.utils import backend

    rows, cols = 64, 4096
    rs = np.random.RandomState(seed=1)
    x = jnp.asarray(np.abs(rs.standard_normal((rows, cols))).astype(np.float32))
    xc = jnp.asarray((rs.standard_normal((cols, rows))
                      + 1j * rs.standard_normal((cols, rows))).astype(np.complex64))
    xm = jnp.asarray(rs.random_sample(cols).astype(np.float32))
    # The shipped table's record is keyed at max_columns=5000 (the reference
    # percentiletest width), a capacity that covers this call.
    tmpl = pct.Percentile5Template(backend.create_some_context(), 5000, True)
    log(f"config2 percentile engine: {tmpl.engine}")
    t_pct = timing(lambda a: pct.percentile5(a, engine=tmpl.engine), x, iters=args.iters)
    t_ms = timing(ms.maskedsum, xc, xm, iters=args.iters)
    n = rows * cols
    roof = TARGET_FRACTION * hbm_gbps * 1e9
    return [
        record("percentile5_64x4k_elements_per_second", n / t_pct["seconds"], "elem/s",
               n * 4 / t_pct["seconds"] / roof, t_pct, engine=tmpl.engine),
        record("maskedsum_4kx64_elements_per_second", n / t_ms["seconds"], "elem/s",
               n * 8 / t_ms["seconds"] / roof, t_ms),
    ]


def bench_config3(args, hbm_gbps):
    """BASELINE.json config 3: 2016 baselines × 8k channels complex64 corner
    turn (transpose), next to a plain copy of the same bytes, plus a row
    reduction."""
    import jax
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import transpose as tr, wgreduce

    rows, cols = 8192, 2016
    rs = np.random.RandomState(seed=1)
    data = (rs.standard_normal((rows, cols)) + 1j * rs.standard_normal((rows, cols)))
    x = jnp.asarray(data.astype(np.complex64))
    nbytes = rows * cols * 8 * 2  # read + write
    roof = TARGET_FRACTION * hbm_gbps * 1e9
    t = timing(jax.jit(tr.transpose), x, iters=args.iters)
    t_copy = timing(jax.jit(lambda a: a + jnp.complex64(1)), x, iters=args.iters)
    log(f"config3 transpose {rows}x{cols} c64: {nbytes / t['seconds'] / 1e9:.1f} GB/s; "
        f"copy of the same bytes {nbytes / t_copy['seconds'] / 1e9:.1f} GB/s")
    amp = jnp.abs(x)
    t_r = timing(jax.jit(lambda a: wgreduce.reduce(a, wgreduce.plus, axis=1)), amp,
                 iters=args.iters)
    rbytes = rows * cols * 4  # one read; output negligible
    return [
        record("transpose_8kx2016_bytes_per_second", nbytes / t["seconds"], "B/s",
               nbytes / t["seconds"] / roof, t,
               copy_bytes_per_second=nbytes / t_copy["seconds"]),
        record("hreduce_8kx2016_bytes_per_second", rbytes / t_r["seconds"], "B/s",
               rbytes / t_r["seconds"] / roof, t_r),
    ]


def bench_config4(args, hbm_gbps):
    """BASELINE.json config 4: FFT-path spectral flagging — r2c FFT +
    MAD threshold + c2r over 256 baselines × 32k samples."""
    import jax
    import jax.numpy as jnp

    from katsdpsigproc_tpu.models.rfi import device

    b, c = 256, 32768
    x = jnp.asarray(np.random.RandomState(seed=1).standard_normal((b, c)).astype(np.float32))
    t = timing(jax.jit(device.spectral_flag), x, iters=args.iters)
    n = b * c
    # Minimum traffic: read 4 B + write 4 B cleaned + 1 B flag per sample.
    return [record("fft_spectral_flag_samples_per_second", n / t["seconds"], "samples/s",
                   n * 9 / t["seconds"] / (TARGET_FRACTION * hbm_gbps * 1e9), t)]


def bench_flagger(args, hbm_gbps):
    """Config 5, the headline: the 1-D flagger on the pol-flattened dump."""
    import jax.numpy as jnp

    import chip_smoke
    from katsdpsigproc_tpu.models.rfi import device as rfi_device

    rows = args.baselines * args.pols
    if args.pols > 1:
        # Each polarization is an independent spectrum: the flagger treats
        # the dump as baselines*pols rows (the reference flags each pol
        # product as its own baseline column, rfiflagtest.py).
        log(f"pol-flattening: {args.baselines} baselines x {args.pols} pols -> {rows} rows")
    vis = chip_smoke.make_dump(chip_smoke.SEED, args.channels, rows)
    fn = rfi_device.make_flagger_fn(args.width, 11.0, threshold="sum",
                                    baseline_block=min(args.slab, rows))
    if not args.skip_parity:
        flags = fn(vis)
        columns = chip_smoke.parity_columns(rows)
        n = chip_smoke.check_flagger_vs_host(vis, flags, columns, width=args.width)
        log(f"parity: {columns.size} complete baselines, {n} flags bit-identical "
            f"to the host oracle")

    n_vis = args.channels * rows
    t = timing(fn, vis, iters=args.iters)
    value = n_vis / t["seconds"]
    roofline = hbm_gbps * 1e9 / BYTES_PER_VIS
    extra = {"rows": rows, "pols": args.pols, "engine": "xla"}
    if args.pols > 1:
        # 1-pol side record: the same engine on the pol-less dump, so every
        # record carries the per-vis rate at both production shapes.
        t1 = timing(fn, vis[:, :args.baselines], iters=args.iters)
        v1 = args.channels * args.baselines / t1["seconds"]
        extra["onepol"] = {"rows": args.baselines, "vis_per_second": v1,
                           "per_vis_ratio": value / v1, **t1}
        log(f"onepol: {t1['seconds'] * 1e3:.3f} ms ({v1 / 1e9:.2f} Gvis/s)")
    # Same-call streaming probe: a plain read+write of 1 GiB.
    stream = jnp.zeros((256, 1024, 1024), jnp.float32)
    t_copy = timing(lambda a: a + 1.0, stream, iters=args.iters)
    extra["measured_copy_gbps"] = 2 * stream.nbytes / t_copy["seconds"] / 1e9
    log(f"flagger {rows}x{args.channels}: {t['seconds'] * 1e3:.3f} ms "
        f"({value / 1e9:.2f} Gvis/s; {value / roofline * 100:.1f}% of the "
        f"{hbm_gbps:.0f} GB/s roofline); copy probe {extra['measured_copy_gbps']:.0f} GB/s")
    return [record("rfi_flagger_visibilities_per_second_per_chip", value, "vis/s",
                   value / (TARGET_FRACTION * roofline), t, **extra)]


CONFIGS = {"1": bench_config1, "2": bench_config2, "3": bench_config3, "4": bench_config4,
           "5": bench_flagger}


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--channels", type=int, default=32768)
    parser.add_argument("--baselines", type=int, default=2016)
    parser.add_argument("--pols", type=int, default=4,
                        help="polarizations per baseline; the dump is pol-flattened to "
                             "baselines*pols independent rows")
    parser.add_argument("--width", type=int, default=13)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--slab", type=int, default=288, help="baselines per flagger slab")
    parser.add_argument("--skip-parity", action="store_true")
    parser.add_argument("--config", choices=sorted(CONFIGS) + ["all"], default="5",
                        help="BASELINE.json config to run (5 = the headline dump)")
    args = parser.parse_args()

    import jax

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()
    dev = jax.devices()[0]
    hbm = peak_hbm_gbps(dev.device_kind)
    ident = {"platform": dev.platform, "device_kind": dev.device_kind,
             "device_count": len(jax.devices())}
    log(f"device: {dev} ({dev.device_kind}), peak {hbm:.0f} GB/s")
    picked = sorted(CONFIGS) if args.config == "all" else [args.config]
    for name in picked:
        for rec in CONFIGS[name](args, hbm):
            print(json.dumps({**rec, **ident}), flush=True)


if __name__ == "__main__":
    main()
