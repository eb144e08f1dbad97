"""Seeded fuzz of the 1-D flagger.

The flagger must produce the host oracle's mask bit-for-bit on random
shapes, widths, window counts, and prior-flag densities — the reference's
oracle pattern (test/rfi/test_flagger.py) stretched across the
configuration space, unblocked and slab-blocked.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from katsdpsigproc_tpu.models.rfi import (
    device as rfi_device,
    host as rfi_host,
)


def _host_flags(vis, width, n_sigma, n_windows, input_flags=None):
    flagger = rfi_host.FlaggerHost(
        rfi_host.BackgroundMedianFilterHost(width),
        rfi_host.NoiseEstMADHost(),
        rfi_host.ThresholdSumHost(n_sigma, n_windows=n_windows),
    )
    return flagger(vis) if input_flags is None else flagger(vis, input_flags)


@pytest.mark.parametrize("seed", range(4))
def test_engines_match_host(seed):
    rs = np.random.RandomState(200 + seed)
    channels = int(rs.choice([192, 256, 384]))
    baselines = int(rs.choice([8, 16]))
    width = int(rs.choice([9, 11, 13]))
    n_windows = int(rs.randint(2, 5))
    n_sigma = float(rs.uniform(8.0, 12.0))
    use_flags = bool(rs.randint(2))

    vis = (rs.standard_normal((channels, baselines))
           + 1j * rs.standard_normal((channels, baselines))).astype(np.complex64)
    spikes = rs.random_sample(vis.shape) < rs.uniform(0.005, 0.04)
    vis += spikes * (20.0 + 30.0 * rs.random_sample(vis.shape))
    input_flags = (rs.random_sample(vis.shape) < 0.05) if use_flags else None

    expected = _host_flags(vis, width, n_sigma, n_windows, input_flags)
    planar = rfi_device.to_planar(vis)

    mode = (rfi_device.BackgroundFlags.FULL if use_flags
            else rfi_device.BackgroundFlags.NONE)
    args = (jnp.asarray(planar),)
    if use_flags:
        args += (jnp.asarray(input_flags.astype(np.uint8)),)
    for block in (None, 3):
        fn = rfi_device.make_flagger_fn(
            width, n_sigma, threshold="sum", n_windows=n_windows, use_flags=mode,
            baseline_block=block)
        np.testing.assert_equal(np.asarray(fn(*args)), expected,
                                err_msg=f"baseline_block={block}")
