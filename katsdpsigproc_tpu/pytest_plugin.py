"""Pytest plugin: device-parametrized fixtures and autotune stubbing.

Mirrors the reference plugin (reference: src/katsdpsigproc/pytest_plugin.py:30-131):

* fixture ``device`` — parametrized over candidate JAX devices, filtered by
  marks and the ``--devices`` option (``first-per-api`` → first per
  platform, ``all``, ``none``); with no matching device the test xfails
  with "No matching device found" rather than silently passing
  (reference pytest_plugin.py:120-127);
* fixture ``context`` — a :class:`~katsdpsigproc_tpu.utils.backend.DeviceContext`
  for the device, with autotuning stubbed (reference pytest_plugin.py:30-47);
* fixture ``patch_autotune`` — monkeypatches
  :data:`katsdpsigproc_tpu.utils.tune.autotuner_impl` to the deterministic
  stub so unit tests never benchmark; the ``force_autotune`` mark switches
  to the real search (reference pytest_plugin.py:31-35);
* marks ``gpu`` (the test needs an NVIDIA GPU: an autouse fixture skips
  it, with a reason, when JAX's first device is not one — decided per test
  inside the fixture, never at import or collection time, so every
  pytest-xdist worker collects the same tests), ``cpu_only``,
  ``device_filter(fn)``.

Activate with ``pytest_plugins = ["katsdpsigproc_tpu.pytest_plugin"]`` in a
top-level conftest.
"""

from typing import List

import pytest

from .utils import backend, tune


def pytest_addoption(parser):
    group = parser.getgroup("katsdpsigproc_tpu")
    group.addoption(
        "--devices",
        choices=["first-per-api", "all", "none"],
        default="first-per-api",
        help="Which JAX devices to parametrize device tests over",
    )


def pytest_configure(config):
    for mark in ["gpu", "cpu_only", "device_filter", "force_autotune"]:
        config.addinivalue_line("markers", f"{mark}: see katsdpsigproc_tpu.pytest_plugin")


def _candidate_devices(config) -> List:
    mode = config.getoption("--devices", default="first-per-api")
    if mode == "none":
        return []
    devices = backend.candidate_devices()
    if mode == "first-per-api":
        seen = set()
        picked = []
        for d in devices:
            if d.platform not in seen:
                seen.add(d.platform)
                picked.append(d)
        return picked
    return devices


def pytest_generate_tests(metafunc):
    if "device" in metafunc.fixturenames:
        devices = _candidate_devices(metafunc.config)
        for mark in metafunc.definition.iter_markers("cpu_only"):
            devices = [d for d in devices if d.platform == "cpu"]
        for mark in metafunc.definition.iter_markers("device_filter"):
            devices = [d for d in devices if mark.args[0](d)]
        if not devices:
            # Parametrize with a sentinel that xfails (reference behaviour).
            metafunc.parametrize("device", [None], ids=["no-device"])
        else:
            metafunc.parametrize("device", devices, ids=[str(d) for d in devices])


def gpu_skip_reason():
    """Why a ``gpu``-marked test cannot run here, or None if it can."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        return f"needs an NVIDIA GPU; JAX's first device is {platform!r}"
    return None


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") is not None:
        reason = gpu_skip_reason()
        if reason is not None:
            pytest.skip(reason)


@pytest.fixture
def device(request):
    dev = request.param
    if dev is None:
        pytest.xfail("No matching device found")
    return dev


@pytest.fixture
def patch_autotune(request, monkeypatch):
    if request.node.get_closest_marker("force_autotune"):
        monkeypatch.setattr(tune, "autotuner_impl", tune.force_autotuner)
    else:
        monkeypatch.setattr(tune, "autotuner_impl", tune.stub_autotuner)


@pytest.fixture
def context(device, patch_autotune):
    return backend.DeviceContext(device)


@pytest.fixture
def command_queue(context):
    """Reference parity (pytest_plugin.py:40-52): command queues are
    subsumed by XLA async dispatch, so the placement context stands in
    wherever the reference passes a queue (templates' ``instantiate``
    accepts it as the ``command_queue`` argument)."""
    return context
