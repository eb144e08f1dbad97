#!/usr/bin/env python
"""Benchmark/parity driver for RFI flagging on random data.

Reproduces the reference's harness (reference: scripts/rfiflagtest.py:47-211):
1-D flagger over (channels, baselines), or the 2-D twodflag over
(times, channels, baselines) with ``--time``; prints host (CPU oracle) and
device times and verifies the masks agree.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def generate_data(times, channels, baselines):
    rs = np.random.RandomState(seed=1)
    shape = (channels, baselines) if times is None else (times, channels, baselines)
    out = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 1.0 / 64.0
    out += spikes * (rs.random_sample(shape) * 20.0 + 50.0)
    return out


def benchmark1d(args, data):
    import jax
    import jax.numpy as jnp

    from katsdpsigproc_tpu.models.rfi import device as rfi_device, host as rfi_host

    if args.width % 2 != 1:
        raise ValueError("Width must be odd")
    fn = rfi_device.make_flagger_fn(args.width, args.sigmas, threshold="sum")
    # Planar split-complex layout: the image of interleaved complex64
    vis = jnp.asarray(rfi_device.to_planar(data))
    start = time.perf_counter()
    flags = np.asarray(jax.block_until_ready(fn(vis)))
    print(f"Device compile+run: {(time.perf_counter() - start) * 1000:.1f} ms", file=sys.stderr)
    start = time.perf_counter()
    jax.block_until_ready(fn(vis))
    device_ms = (time.perf_counter() - start) * 1000
    print(f"Device steady-state: {device_ms:.3f} ms", file=sys.stderr)

    if not args.skip_host:
        host_flagger = rfi_host.FlaggerHost(
            rfi_host.BackgroundMedianFilterHost(args.width),
            rfi_host.NoiseEstMADHost(),
            rfi_host.ThresholdSumHost(args.sigmas),
        )
        start = time.perf_counter()
        expected = host_flagger(data)
        host_ms = (time.perf_counter() - start) * 1000
        print(f"Host (oracle): {host_ms:.1f} ms", file=sys.stderr)
        mismatch = int((expected != flags).sum())
        print(f"Mask mismatches: {mismatch} / {flags.size}", file=sys.stderr)
        return mismatch == 0
    return True


def benchmark2d(args, data):
    from katsdpsigproc_tpu.models.rfi import twodflag

    flagger = twodflag.SumThresholdFlagger(outlier_nsigma=args.sigmas)
    in_flags = np.zeros(data.shape, bool)
    start = time.perf_counter()
    flags = flagger.get_flags(np.abs(data), in_flags)
    print(f"2-D flagger (compile+run): {(time.perf_counter() - start) * 1000:.1f} ms",
          file=sys.stderr)
    start = time.perf_counter()
    flagger.get_flags(np.abs(data), in_flags)
    print(f"2-D flagger (steady): {(time.perf_counter() - start) * 1000:.1f} ms", file=sys.stderr)
    print(f"Flagged fraction: {flags.mean():.4f}", file=sys.stderr)
    return True


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--time", type=int, help="Number of dumps (selects the 2-D flagger)")
    parser.add_argument("--channels", type=int, default=1024)
    parser.add_argument("--baselines", type=int, default=512)
    parser.add_argument("--width", type=int, default=13)
    parser.add_argument("--sigmas", type=float, default=11.0)
    parser.add_argument("--skip-host", action="store_true")
    args = parser.parse_args()

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()
    data = generate_data(args.time, args.channels, args.baselines)
    if args.time is None:
        ok = benchmark1d(args, data)
    else:
        ok = benchmark2d(args, data)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
