"""The public legacy test-helper module (reference test/test_accel.py:26-122)."""

from katsdpsigproc_tpu.test import test_accel as legacy
from katsdpsigproc_tpu.utils import backend, tune


def test_device_test_injects_context_and_stubs_autotune():
    seen = {}

    @legacy.device_test
    def my_test(context, device):
        seen["context"] = context
        seen["device"] = device
        # autotuning is stubbed to the deterministic test= values
        seen["tuning"] = tune.autotuner_impl({"wgs": 7}, None)

    my_test()
    assert isinstance(seen["context"], backend.DeviceContext)
    assert seen["device"] is seen["context"].device
    assert seen["tuning"] == {"wgs": 7}
    # the stub is removed outside the test
    assert tune.autotuner_impl is not tune.stub_autotuner


def test_device_test_async():
    import asyncio

    seen = {}

    @legacy.device_test
    async def my_test(context, device):
        seen["context"] = context

    asyncio.run(my_test())
    assert isinstance(seen["context"], backend.DeviceContext)


def test_gpu_marker_skips_off_gpu():
    """The ``gpu`` marker (the reference's ``cuda_test``) skips with a
    reason wherever JAX's first device is not a GPU — here, the CPU."""
    from katsdpsigproc_tpu import pytest_plugin

    reason = pytest_plugin.gpu_skip_reason()
    assert reason is not None and "'cpu'" in reason


def test_gpu_marker_registered(pytestconfig):
    markers = pytestconfig.getini("markers")
    assert any(m.startswith("gpu:") for m in markers)


def test_force_autotune():
    seen = {}

    @legacy.force_autotune
    def my_test():
        seen["impl"] = tune.autotuner_impl

    my_test()
    assert seen["impl"] is tune.force_autotuner


def test_decorators_not_collected():
    assert legacy.device_test.__test__ is False
    assert legacy.force_autotune.__test__ is False
