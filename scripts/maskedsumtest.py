#!/usr/bin/env python
"""Masked-sum benchmark + parity vs numpy (reference:
scripts/maskedsumtest.py:26-45 — 4000×5000 complex64; use
--amplitudes for the maskedsumabstest variant)."""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=4000)
    parser.add_argument("--cols", type=int, default=5000)
    parser.add_argument("--amplitudes", action="store_true")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from katsdpsigproc_tpu.ops import maskedsum
    from katsdpsigproc_tpu.utils import profiling

    ctx = backend.create_some_context()
    err = chip_smoke.check_maskedsum(args.rows, args.cols, args.amplitudes)
    print(f"worst relative error vs a float64 sum: {err:.3g} "
          f"(bound {chip_smoke.MASKEDSUM_RTOL})", file=sys.stderr)

    op = maskedsum.MaskedSumTemplate(ctx, args.amplitudes).instantiate(
        None, (args.rows, args.cols))
    rs = np.random.RandomState(seed=1)
    src = jnp.asarray((rs.standard_normal((args.rows, args.cols))
                       + 1j * rs.standard_normal((args.rows, args.cols))).astype(np.complex64))
    mask = jnp.asarray(rs.uniform(size=(args.rows,)).astype(np.float32))
    samples = profiling.time_samples(lambda: op(src=src, mask=mask)["dest"], iters=args.iters)
    print(f"device ({ctx.device_kind}): {chip_smoke.spread(samples)}", file=sys.stderr)


if __name__ == "__main__":
    main()
