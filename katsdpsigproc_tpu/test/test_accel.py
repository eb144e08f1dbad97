"""Framework-agnostic device-test decorators for downstream packages.

The reference ships ``katsdpsigproc.test.test_accel`` as a *public*
module (excluded from its own test run, reference pytest.ini:4) so that
downstream packages using plain ``unittest``/nose-style tests — not the
pytest plugin — can decorate device tests
(reference: src/katsdpsigproc/test/test_accel.py:26-122):

* :func:`device_test` — inject a context (and the default device) into
  the test, stub the autotuner to its deterministic ``test=`` values,
  and skip when no device is available;
* :func:`force_autotune` — run the real autotune search inside a test.

``unittest.SkipTest`` replaces nose's ``SkipTest`` (nose is dead;
``unittest.SkipTest`` is recognised by unittest AND pytest).  For pytest
suites prefer the fixtures in :mod:`katsdpsigproc_tpu.pytest_plugin`, whose
``gpu`` marker takes the place of the reference's ``cuda_test``.
"""

import functools
import inspect
import sys
import unittest
from typing import Callable, Optional, Tuple, TypeVar
from unittest import mock

from ..utils import backend, tune

_T = TypeVar("_T")

_test_initialized = False
_test_context: Optional[backend.DeviceContext] = None


def _prepare_device_test() -> Tuple[backend.DeviceContext, object]:
    """Create (once) and return the shared test context and its device.

    Reference: test/test_accel.py:26-46 (_prepare_device_test).
    """
    global _test_initialized, _test_context
    if not _test_initialized:
        try:
            _test_context = backend.create_some_context(interactive=False)
            print(
                f"Testing on {_test_context.device.device_kind} "
                f"({_test_context.platform})",
                file=sys.stderr,
            )
        except RuntimeError:
            pass  # no devices available
        _test_initialized = True
    if _test_context is None:
        raise unittest.SkipTest("no JAX device found")
    return _test_context, _test_context.device


def _device_test_sync(test: Callable[..., _T]) -> Callable[..., _T]:
    @functools.wraps(test)
    def wrapper(*args, **kwargs) -> _T:
        context, device = _prepare_device_test()
        with mock.patch.object(tune, "autotuner_impl", new=tune.stub_autotuner):
            return test(*(args + (context, device)), **kwargs)

    return wrapper


def _device_test_async(test: Callable[..., _T]) -> Callable[..., _T]:
    @functools.wraps(test)
    async def wrapper(*args, **kwargs):
        context, device = _prepare_device_test()
        with mock.patch.object(tune, "autotuner_impl", new=tune.stub_autotuner):
            return await test(*(args + (context, device)), **kwargs)

    return wrapper


def device_test(test: Callable[..., _T]) -> Callable[..., _T]:
    """Decorate an on-device test (sync or async).

    Appends ``(context, device)`` to the test's positional arguments,
    skips the test when no device is available, and stubs autotuning to
    the deterministic ``test=`` values (reference:
    test/test_accel.py:79-93).  For a real autotune search stack
    :func:`force_autotune` *inside* (after) this decorator.
    """
    if inspect.iscoroutinefunction(test):
        return _device_test_async(test)
    return _device_test_sync(test)


def force_autotune(test: Callable[..., _T]) -> Callable[..., _T]:
    """Force real autotuning inside a test (reference: test/test_accel.py:113-119)."""

    @functools.wraps(test)
    def wrapper(*args, **kwargs) -> _T:
        with mock.patch.object(tune, "autotuner_impl", new=tune.force_autotuner):
            return test(*args, **kwargs)

    return wrapper


# Prevent test collectors from treating the decorators as tests.
device_test.__test__ = False  # type: ignore[attr-defined]
force_autotune.__test__ = False  # type: ignore[attr-defined]
