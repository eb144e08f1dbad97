"""Randomized cross-engine sweeps for the primitive ops vs numpy oracles.

Same philosophy as the flagger fuzz sweeps: seeded draws over shapes and
engine options, each checked exactly against numpy (percentile uses the
reference's ``np.percentile(..., 'lower')`` contract; transpose/reduce/
maskedsum against direct numpy expressions).  Engines are independently
implemented, so agreement at random shapes is strong evidence against
shape-edge bugs (lane tails, odd row counts, padding).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from katsdpsigproc_tpu.ops import (  # noqa: E402
    maskedsum as ms,
    percentile as pct,
    transpose as tr,
    wgreduce,
)


def _draws(seed, n):
    return np.random.RandomState(seed).randint(0, 1 << 30, size=n)


@pytest.mark.parametrize("seed", _draws(11, 4))
def test_percentile5_engines(seed):
    rs = np.random.RandomState(seed)
    rows = int(rs.randint(1, 40))
    cols = int(rs.randint(5, 700))
    data = np.abs(rs.standard_normal((rows, cols))).astype(np.float32) + 0.01
    x = jnp.asarray(data)
    expected = np.stack([
        data.min(axis=1), data.max(axis=1),
        np.percentile(data, 25, axis=1, method="lower").astype(np.float32),
        np.percentile(data, 75, axis=1, method="lower").astype(np.float32),
        np.percentile(data, 50, axis=1, method="lower").astype(np.float32),
    ])
    for engine in ("rank", "sort"):
        got = np.asarray(pct.percentile5(x, engine=engine))
        np.testing.assert_array_equal(got, expected, err_msg=f"engine={engine}")


@pytest.mark.parametrize("seed", _draws(12, 6))
def test_transpose_engines(seed):
    rs = np.random.RandomState(seed)
    rows = int(rs.randint(1, 300))
    cols = int(rs.randint(1, 300))
    data = rs.standard_normal((rows, cols)).astype(np.float32)
    x = jnp.asarray(data)
    np.testing.assert_array_equal(np.asarray(tr.transpose(x)), data.T)
    planar = np.stack([data, -data], axis=-1)
    np.testing.assert_array_equal(np.asarray(tr.transpose(jnp.asarray(planar))),
                                  np.swapaxes(planar, 0, 1))


@pytest.mark.parametrize("seed", _draws(13, 6))
def test_reduce_ops(seed):
    rs = np.random.RandomState(seed)
    rows = int(rs.randint(1, 50))
    cols = int(rs.randint(1, 500))
    data = rs.standard_normal((rows, cols)).astype(np.float32)
    x = jnp.asarray(data)
    np.testing.assert_allclose(
        np.asarray(wgreduce.reduce(x, wgreduce.plus, axis=1)),
        data.sum(axis=1), rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(wgreduce.reduce(x, wgreduce.fmax, axis=1)), data.max(axis=1))
    np.testing.assert_array_equal(
        np.asarray(wgreduce.reduce(x, wgreduce.fmin, axis=1)), data.min(axis=1))


@pytest.mark.parametrize("seed", _draws(14, 6))
def test_maskedsum_variants(seed):
    rs = np.random.RandomState(seed)
    rows = int(rs.randint(2, 400))   # channels
    cols = int(rs.randint(1, 60))    # baselines
    cdata = (rs.standard_normal((rows, cols))
             + 1j * rs.standard_normal((rows, cols))).astype(np.complex64)
    planar = np.stack([cdata.real, cdata.imag], axis=-1).astype(np.float32)
    mask = (rs.random_sample(rows) < 0.7).astype(np.float32)
    got = np.asarray(ms.maskedsum(jnp.asarray(planar), jnp.asarray(mask)))
    expected = (cdata * mask[:, None]).sum(axis=0)
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], expected,
                               rtol=2e-4, atol=2e-4)
    got_amp = np.asarray(ms.maskedsum(jnp.asarray(planar), jnp.asarray(mask),
                                      use_amplitudes=True))
    expected_amp = (np.abs(cdata) * mask[:, None]).sum(axis=0)
    np.testing.assert_allclose(got_amp, expected_amp, rtol=2e-4, atol=2e-4)
