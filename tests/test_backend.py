"""Device discovery tests (reference: accel.py device selection logic)."""

import jax
import pytest

from katsdpsigproc_tpu.utils import backend


def test_all_devices():
    assert len(backend.all_devices()) >= 1


def test_env_pinning(monkeypatch):
    devices = backend.all_devices()
    monkeypatch.setenv("KATSDPSIGPROC_TPU_DEVICE", "0")
    assert backend.candidate_devices() == [devices[0]]
    monkeypatch.setenv("KATSDPSIGPROC_TPU_DEVICE", str(len(devices)))
    with pytest.raises(IndexError):
        backend.candidate_devices()


def test_device_filter():
    assert backend.candidate_devices(lambda d: False) == []
    with pytest.raises(RuntimeError, match="No matching device"):
        backend.create_some_context(device_filter=lambda d: False)


def test_create_some_context_and_put():
    ctx = backend.create_some_context()
    assert ctx.platform == jax.devices()[0].platform
    import jax.numpy as jnp

    x = ctx.put(jnp.ones(4))
    assert x.devices() == {ctx.device}


def test_device_kind_key():
    platform, kind = backend.device_kind_key()
    assert isinstance(platform, str) and isinstance(kind, str)


def test_command_queue_fixture(command_queue, context):
    """Reference parity: the command_queue fixture is the placement context
    (queues are subsumed by XLA async dispatch)."""
    assert command_queue is context


def test_create_some_context_interactive(monkeypatch):
    """Reference parity (accel.py:349-361): interactive + tty + multiple
    candidates prompts for an index; invalid selections raise RuntimeError."""
    import sys

    devs = backend.all_devices()
    if len(devs) < 2:
        pytest.skip("needs >= 2 devices")
    monkeypatch.setattr(sys.stdin, "isatty", lambda: True)
    monkeypatch.setattr("builtins.input", lambda prompt="": "1")
    ctx = backend.create_some_context(interactive=True, devices=devs)
    assert ctx.device == devs[1]
    for bad in ("-1", "notanumber", str(len(devs))):
        monkeypatch.setattr("builtins.input", lambda prompt="", b=bad: b)
        with pytest.raises(RuntimeError):
            backend.create_some_context(interactive=True, devices=devs)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """A set JAX_COMPILATION_CACHE_DIR is used as it stands: nothing else
    is configured."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_fixed_default(monkeypatch):
    """Unset, the cache lives at a fixed path inside the checkout (the path
    is part of the cache key), and that path is gitignored."""
    import pathlib

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert backend.enable_compile_cache() == str(repo / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(repo / ".jax_cache"))]
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


def test_platform_rank_prefers_gpu():
    class Fake:
        def __init__(self, platform):
            self.platform = platform

    ranked = sorted([Fake("cpu"), Fake("gpu")], key=backend._rank, reverse=True)
    assert [d.platform for d in ranked] == ["gpu", "cpu"]
    assert set(backend._PLATFORM_RANK) == {"gpu", "cuda", "rocm", "cpu"}
