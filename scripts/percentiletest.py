#!/usr/bin/env python
"""Percentile benchmark + parity vs numpy (reference:
scripts/percentiletest.py:29-44 — 4000×5000 float32, exact match against
np.percentile 'lower')."""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=4000)
    parser.add_argument("--cols", type=int, default=5000)
    parser.add_argument("--engine", choices=["rank", "sort"], default=None,
                        help="force an engine (default: the tuned-table choice)")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from katsdpsigproc_tpu.ops import percentile
    from katsdpsigproc_tpu.utils import profiling

    ctx = backend.create_some_context()
    tuning = {"engine": args.engine} if args.engine else None
    template = percentile.Percentile5Template(ctx, args.cols, True, tuning=tuning)
    print(f"engine: {template.engine}", file=sys.stderr)
    chip_smoke.check_percentile(args.rows, args.cols, template.engine)
    print("exact match vs np.percentile(..., 'lower')", file=sys.stderr)

    op = template.instantiate(None, (args.rows, args.cols))
    v = jnp.asarray(np.random.RandomState(1).uniform(size=(args.rows, args.cols))
                    .astype(np.float32))
    samples = profiling.time_samples(lambda: op(src=v)["dest"], iters=args.iters)
    print(f"device ({ctx.device_kind}): {chip_smoke.spread(samples)}", file=sys.stderr)


if __name__ == "__main__":
    main()
