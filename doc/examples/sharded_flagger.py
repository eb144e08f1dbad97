#!/usr/bin/env python
"""Multi-device RFI flagging on a device mesh (user guide ch. 10).

Runs on a virtual 8-device CPU mesh so no GPUs are needed; on real
hardware the same code spans every card (swap the platform env and,
multi-host, call ``parallel.multihost.initialize`` first).

Shows both sharded pipelines:

* the 1-D flagger with baselines as data parallelism and channels as the
  sequence-parallel axis (halo exchanges + collective noise estimates);
* the 2-D time-frequency flagger with baselines sharded (zero
  collectives — the reference fans the same axis out to process pools,
  rfi/twodflag.py:1029-1118).
"""

import os

# Request 8 virtual CPU devices BEFORE the first jax backend init.
os.environ.setdefault("KATSDPSIGPROC_TPU_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from katsdpsigproc_tpu.utils import backend  # noqa: E402

backend.apply_platform_env()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from katsdpsigproc_tpu.models.rfi import host as rfi_host, twodflag  # noqa: E402
from katsdpsigproc_tpu.parallel import flagger as pflagger, mesh as pmesh  # noqa: E402


def main():
    print(f"devices: {jax.device_count()} × {jax.devices()[0].platform}")

    # --- 1-D flagger over a (baseline × channel) mesh -------------------
    m = pmesh.make_mesh((2, 4), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))
    rs = np.random.RandomState(seed=1)
    channels, baselines = 256, 16
    vis = (rs.standard_normal((channels, baselines))
           + 1j * rs.standard_normal((channels, baselines))).astype(np.complex64)
    vis[100, :] *= 50.0  # planted spike

    fn = pflagger.make_sharded_flagger(m, width=13, n_sigma=11.0, threshold="sum")
    flags = np.asarray(fn(pmesh.shard(m, vis)))

    # Host oracle parity (the same assertion the tests make)
    host_flagger = rfi_host.FlaggerHost(
        rfi_host.BackgroundMedianFilterHost(13),
        rfi_host.NoiseEstMADHost(),
        rfi_host.ThresholdSumHost(11.0),
    )
    expected = host_flagger(np.abs(vis))
    mismatches = int((flags != expected).sum())
    print(f"1-D sharded flagger: flagged {flags.sum()} / {flags.size}, "
          f"mismatches vs host oracle: {mismatches}")
    assert mismatches == 0

    # --- 2-D flagger, baselines sharded ---------------------------------
    m1 = pmesh.make_mesh((8,), (pmesh.BASELINE_AXIS,))
    shape = (32, 96, 12)
    data = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    data[10] *= 20.0
    in_flags = np.zeros(shape, np.bool_)

    flagger2d = twodflag.SumThresholdFlagger(freq_chunks=4)
    out = flagger2d.get_flags_sharded(data, in_flags, m1)
    expected2d = flagger2d.get_flags(data, in_flags)
    assert np.array_equal(out, expected2d)
    print(f"2-D sharded flagger: flagged fraction {out.mean():.4f} "
          f"(matches single-device bit-for-bit)")


if __name__ == "__main__":
    main()
