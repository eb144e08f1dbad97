#!/usr/bin/env python
"""Transpose benchmark (reference: scripts/transposetest.py:11-25 —
3072×8320 complex64), next to a plain copy of the same bytes."""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=3072)
    parser.add_argument("--cols", type=int, default=8320)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from katsdpsigproc_tpu.ops import transpose
    from katsdpsigproc_tpu.utils import profiling

    ctx = backend.create_some_context()
    chip_smoke.check_transpose(args.rows, args.cols)
    op = transpose.TransposeTemplate(ctx, np.complex64).instantiate(None, (args.rows, args.cols))
    rs = np.random.RandomState(seed=1)
    src = jnp.asarray((rs.standard_normal((args.rows, args.cols))
                       + 1j * rs.standard_normal((args.rows, args.cols))).astype(np.complex64))
    nbytes = 2 * src.nbytes  # read + write
    copy = jax.jit(lambda x: x + jnp.complex64(1))
    for name, fn in (("transpose", lambda: op(src=src)["dest"]), ("copy", lambda: copy(src))):
        samples = profiling.time_samples(fn, iters=args.iters)
        print(f"{name} {args.rows}x{args.cols} c64 ({ctx.device_kind}): "
              f"{chip_smoke.spread(samples)}; {nbytes / np.median(samples) / 1e9:.1f} GB/s",
              file=sys.stderr)


if __name__ == "__main__":
    main()
