"""Device discovery and selection.

The reference enumerates CUDA/OpenCL devices, honours environment-variable
pinning, and ranks candidates (reference: src/katsdpsigproc/accel.py:211-365).
Under JAX the runtime owns enumeration; this module provides the same user
contract — "give me the device(s) I should use" — in JAX terms:

* :func:`all_devices` / :func:`candidate_devices` — enumeration with
  ``KATSDPSIGPROC_TPU_DEVICE`` pinning (index into ``jax.devices()``),
  mirroring ``KATSDPSIGPROC_DEVICE`` (reference accel.py:264-271).
* :func:`create_some_context` — returns a :class:`DeviceContext` wrapping a
  device (single-chip) for op placement, preferring GPU > CPU the way the
  reference prefers CUDA > GPU > accelerator > CPU (accel.py:335-363).
* :func:`device_kind_key` — the (platform, device_kind) pair used as the
  tuning-table key (the analogue of the reference's device name/platform/
  driver columns, tune.py:107-128).
* :func:`enable_compile_cache` — the persistent compilation cache every
  entry point shares.
"""

import os
import pathlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import jax

_PLATFORM_RANK = {"gpu": 50, "cuda": 50, "rocm": 50, "cpu": 30}

#: Default compile-cache directory: fixed, inside the checkout (the path is
#: part of the cache key, so it must not move between runs).
DEFAULT_COMPILE_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def apply_platform_env() -> None:
    """Honour ``KATSDPSIGPROC_TPU_PLATFORM`` (e.g. ``cpu``) if set.

    Some deployment environments pre-import jax and pin JAX_PLATFORMS
    before user code runs, so an env-var override must go through
    ``jax.config`` — scripts call this before touching devices.
    """
    platform = os.environ.get("KATSDPSIGPROC_TPU_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX
    reads it itself) and nothing else is configured.  Otherwise the cache
    lives in :data:`DEFAULT_COMPILE_CACHE`.  Call before the first compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def all_devices() -> List[jax.Device]:
    """All addressable JAX devices (reference: accel.py:211-219)."""
    return list(jax.local_devices())


def candidate_devices(device_filter=None) -> List[jax.Device]:
    """Devices to consider, honouring ``KATSDPSIGPROC_TPU_DEVICE`` pinning.

    The environment variable holds an index into :func:`all_devices`
    (reference: accel.py:222-299 — env pinning via KATSDPSIGPROC_DEVICE).
    """
    devices = all_devices()
    env = os.environ.get("KATSDPSIGPROC_TPU_DEVICE")
    if env is not None:
        idx = int(env)
        if not 0 <= idx < len(devices):
            raise IndexError(f"KATSDPSIGPROC_TPU_DEVICE={idx} out of range ({len(devices)} devices)")
        devices = [devices[idx]]
    if device_filter is not None:
        devices = [d for d in devices if device_filter(d)]
    return devices


def _rank(device: jax.Device) -> int:
    return _PLATFORM_RANK.get(device.platform.lower(), 10)


@dataclass
class DeviceContext:
    """A single-device placement context.

    The reference's ``AbstractContext`` owns compilation and allocation
    (abc.py:160-245); under JAX those are global, so this context carries
    only the placement target plus convenience helpers.  Multi-device work
    goes through :mod:`katsdpsigproc_tpu.parallel` meshes instead.
    """

    device: jax.Device
    extra: dict = field(default_factory=dict)

    @property
    def platform(self) -> str:
        return self.device.platform

    @property
    def device_kind(self) -> str:
        return self.device.device_kind

    def put(self, x):
        """Place an array on this context's device."""
        return jax.device_put(x, self.device)

    def __repr__(self) -> str:  # pragma: nocover
        return f"DeviceContext({self.device})"


def create_some_context(
    interactive: bool = False, device_filter=None, devices: Optional[Sequence[jax.Device]] = None
) -> DeviceContext:
    """Pick the best available device and wrap it in a :class:`DeviceContext`.

    Mirrors the reference's contract (accel.py:302-365): if `interactive`
    and stdin is a tty and there are multiple candidates, prompt the user
    for a device number (invalid selections raise ``RuntimeError``);
    otherwise choose the best-ranked device, GPU > CPU the way the
    reference prefers CUDA > GPU > accelerator > other.
    """
    import sys

    if devices is None:
        devices = candidate_devices(device_filter)
    if not devices:
        raise RuntimeError("No matching device found")
    if interactive and len(devices) > 1 and sys.stdin.isatty():
        print("Select device:")
        for i, device in enumerate(devices):
            print(f"    [{i}]: {device.device_kind} ({device.platform})")
        print()
        choice_str = input("Enter selection: ")
        try:
            choice = int(choice_str)
            if choice < 0:
                raise IndexError  # no negative indexing (reference accel.py:358-359)
            best = devices[choice]
        except (ValueError, IndexError):
            raise RuntimeError("Invalid device number") from None
    else:
        best = max(devices, key=_rank)
    return DeviceContext(best)


def device_kind_key(device: Optional[jax.Device] = None) -> tuple:
    """(platform, device_kind) tuning-table key for `device` (default: best device)."""
    if device is None:
        device = create_some_context().device
    return (device.platform, device.device_kind)
