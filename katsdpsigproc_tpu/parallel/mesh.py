"""Device-mesh construction and sharding helpers.

New capability relative to the reference, which is single-device with
user-managed contexts (reference: doc/user/init.rst:4-7, accel.py:211-219;
SURVEY.md §2.5).  The scaling model: partition baselines/polarizations —
and optionally channels — over a ``jax.sharding.Mesh``, with XLA
collectives (NCCL on GPUs) for the global reductions.
"""

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: Canonical axis names: baselines (data-parallel) and channels
#: (sequence-parallel analogue — SURVEY.md §5 "Long-context").
BASELINE_AXIS = "baseline"
CHANNEL_AXIS = "channel"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (BASELINE_AXIS,),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    With the default 1-D shape, all devices shard the baseline axis.  A 2-D
    ``shape=(nb, nc)`` with ``axis_names=("baseline", "channel")`` gives the
    hybrid layout used for very long spectra.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def vis_sharding(mesh: Mesh, transposed: bool = False) -> NamedSharding:
    """Sharding for (channels, baselines) arrays (or (baselines, channels))."""
    axes = [name if name in mesh.axis_names else None for name in (CHANNEL_AXIS, BASELINE_AXIS)]
    spec = P(*(axes[::-1] if transposed else axes))
    return NamedSharding(mesh, spec)


def noise_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-baseline (baselines,) arrays."""
    axis = BASELINE_AXIS if BASELINE_AXIS in mesh.axis_names else None
    return NamedSharding(mesh, P(axis))


def shard(mesh: Mesh, array, transposed: bool = False):
    """Place a (channels, baselines)-shaped array onto the mesh.

    Works across processes: when the mesh spans a multi-host slice, every
    process passes the full (replicated) host array and each device takes
    its shard (``device_put`` would reject a multi-process sharding).
    """
    return shard_with_spec(mesh, array, vis_sharding(mesh, transposed).spec)


def shard_with_spec(mesh: Mesh, array, spec):
    """Place an arbitrary host array onto the mesh with ``spec``.

    Same cross-process contract as :func:`shard`: every process passes
    the full (replicated) host array; each device takes its shard.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        array = np.asarray(array)
        return jax.make_array_from_callback(array.shape, sharding, lambda idx: array[idx])
    return jax.device_put(array, sharding)
