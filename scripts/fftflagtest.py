#!/usr/bin/env python
"""FFT-path spectral flagging benchmark (BASELINE.json config 4).

r2c FFT over each baseline's time series → threshold spectral amplitudes
against an MAD noise estimate → zero flagged bins → c2r inverse
(:func:`katsdpsigproc_tpu.models.rfi.device.spectral_flag`), checked
against ``np.fft`` and timed (256 baselines × 32k channels by default).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--baselines", type=int, default=256)
    parser.add_argument("--channels", type=int, default=32768)
    parser.add_argument("--nsigma", type=float, default=5.0)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.utils import profiling

    b, c = args.baselines, args.channels
    n = chip_smoke.check_spectral_flag(b, c, args.nsigma)
    print(f"{n} spectral flags agree with np.fft", file=sys.stderr)
    x = jnp.asarray(chip_smoke.spectral_data(b, c))
    fn = jax.jit(lambda v: device.spectral_flag(v, args.nsigma))
    flags = np.asarray(fn(x)[0])
    print(f"flagged spectral bins: {flags.sum()} ({flags.mean() * 100:.3f}%)", file=sys.stderr)
    samples = profiling.time_samples(lambda: fn(x), iters=args.iters)
    print(f"device ({jax.devices()[0].device_kind}): {chip_smoke.spread(samples)}; "
          f"{b * c / np.median(samples) / 1e9:.2f} Gsamples/s", file=sys.stderr)


if __name__ == "__main__":
    main()
