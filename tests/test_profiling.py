"""Profiling helper tests."""

import jax.numpy as jnp

from katsdpsigproc_tpu.utils import profiling


def test_time_fn():
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(16) * 2

    dt = profiling.time_fn(fn, iters=3, warmup=1)
    assert dt >= 0
    assert len(calls) == 4


def test_annotate():
    with profiling.annotate("test-region"):
        x = jnp.sum(jnp.ones(8))
    assert float(x) == 8.0


def test_time_samples():
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(16)

    samples = profiling.time_samples(fn, iters=5, warmup=2)
    assert samples.shape == (5,)
    assert (samples >= 0).all()
    assert len(calls) == 7  # 2 untimed warm-up calls + 5 timed windows


def test_time_fn_is_median(monkeypatch):
    import numpy as np

    monkeypatch.setattr(profiling, "time_samples",
                        lambda fn, iters, warmup: np.array([3.0, 1.0, 2.0]))
    assert profiling.time_fn(lambda: None, iters=3) == 2.0
