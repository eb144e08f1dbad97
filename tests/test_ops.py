"""Tests for the primitive op library, following the reference's oracle
pattern: every device op is checked against a numpy reference
(SURVEY.md §4; e.g. reference test/test_transpose.py:36-60,
test/test_percentile.py:47-91, test/test_reduce.py:36-116)."""

import jax.numpy as jnp
import numpy as np
import pytest

from katsdpsigproc_tpu.ops import (
    fill,
    maskedsum,
    percentile,
    rank,
    reduce as reduce_mod,
    transpose,
    wgreduce,
)

from .helpers import complex_normal


@pytest.fixture
def ctx(patch_autotune):
    from katsdpsigproc_tpu.utils import backend

    return backend.create_some_context()


class TestFill:
    @pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.complex64])
    def test_fill(self, ctx, dtype):
        template = fill.FillTemplate(ctx, dtype)
        op = template.instantiate(None, (83, 107))
        op.set_value(4)
        op.ensure_all_bound()
        op()
        np.testing.assert_equal(np.asarray(op.buffer("data")), np.full((83, 107), 4, dtype))


class TestTranspose:
    @pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.uint8])
    @pytest.mark.parametrize("shape", [(53, 7), (73, 521)])
    def test_xla(self, ctx, dtype, shape):
        template = transpose.TransposeTemplate(ctx, dtype)
        op = template.instantiate(None, shape)
        rs = np.random.RandomState(seed=1)
        if dtype == np.complex64:
            src = complex_normal(rs, size=shape).astype(dtype)
        else:
            src = (rs.uniform(0, 100, shape)).astype(dtype)
        out = op(src=jnp.asarray(src))["dest"]
        np.testing.assert_equal(np.asarray(out), src.T)

    def test_planar(self, ctx):
        """Planar (R, C, 2) float32 pairs transpose as (C, R, 2)."""
        rs = np.random.RandomState(seed=2)
        src = rs.uniform(0, 100, (48, 260, 2)).astype(np.float32)
        out = transpose.transpose(jnp.asarray(src))
        np.testing.assert_equal(np.asarray(out), np.swapaxes(src, 0, 1))

    def test_tuning_ignored(self, ctx):
        """The template has no search dimension: any ``tuning`` is ignored
        and the op reports only its shape and dtype."""
        template = transpose.TransposeTemplate(ctx, np.complex64, tuning={"engine": "x"})
        op = template.instantiate(None, (3, 5))
        assert op.parameters() == {"dtype": np.dtype(np.complex64), "shape": (3, 5)}
        assert not hasattr(transpose.TransposeTemplate, "autotune")


class TestMaskedSum:
    @pytest.mark.parametrize("use_amplitudes", [False, True])
    def test_result(self, ctx, use_amplitudes):
        shape = (223, 497)
        rs = np.random.RandomState(seed=1)
        src = complex_normal(rs, size=shape).astype(np.complex64)
        mask = rs.uniform(size=(shape[0],)).astype(np.float32)
        template = maskedsum.MaskedSumTemplate(ctx, use_amplitudes)
        op = template.instantiate(None, shape)
        out = op(src=jnp.asarray(src), mask=jnp.asarray(mask))["dest"]
        if use_amplitudes:
            expected = (mask[:, None] * np.abs(src)).sum(axis=0)
        else:
            expected = (mask[:, None] * src).sum(axis=0)
        np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-5, atol=1e-4)


class TestMaskedSumPlanar:
    @pytest.mark.parametrize("use_amplitudes", [False, True])
    def test_matches_complex(self, ctx, use_amplitudes):
        from katsdpsigproc_tpu.models.rfi.device import to_planar

        rs = np.random.RandomState(seed=2)
        src = complex_normal(rs, size=(37, 53)).astype(np.complex64)
        mask = rs.uniform(size=(37,)).astype(np.float32)
        out_c = np.asarray(maskedsum.maskedsum(jnp.asarray(src), jnp.asarray(mask), use_amplitudes))
        out_p = np.asarray(
            maskedsum.maskedsum(jnp.asarray(to_planar(src)), jnp.asarray(mask), use_amplitudes)
        )
        if use_amplitudes:
            np.testing.assert_allclose(out_p, out_c, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(out_p, to_planar(out_c), rtol=1e-5, atol=1e-5)


class TestHReduce:
    @pytest.mark.parametrize(
        "op_name,np_fn", [("plus", np.sum), ("max", np.max), ("min", np.min)]
    )
    @pytest.mark.parametrize("column_range", [None, (7, 300)])
    def test_named_ops(self, ctx, op_name, np_fn, column_range):
        shape = (129, 409)
        rs = np.random.RandomState(seed=1)
        src = rs.standard_normal(shape).astype(np.float32)
        template = reduce_mod.HReduceTemplate(ctx, np.float32, op=op_name)
        op = template.instantiate(None, shape, column_range)
        out = op(src=jnp.asarray(src))["dest"]
        lo, hi = column_range or (0, shape[1])
        np.testing.assert_allclose(
            np.asarray(out), np_fn(src[:, lo:hi], axis=1), rtol=1e-5, atol=1e-4
        )

    def test_custom_op(self, ctx):
        shape = (16, 33)
        rs = np.random.RandomState(seed=1)
        src = rs.standard_normal(shape).astype(np.float32)
        template = reduce_mod.HReduceTemplate(
            ctx, np.float32, op=lambda a, b: jnp.maximum(a, b), identity=-np.inf
        )
        op = template.instantiate(None, shape)
        out = op(src=jnp.asarray(src))["dest"]
        np.testing.assert_allclose(np.asarray(out), src.max(axis=1), rtol=1e-6)

    def test_column_range_validation(self, ctx):
        template = reduce_mod.HReduceTemplate(ctx, np.float32, op="plus")
        with pytest.raises(ValueError):
            template.instantiate(None, (4, 8), (5, 3))
        with pytest.raises(ValueError):
            template.instantiate(None, (4, 8), (0, 9))


class TestRank:
    def test_rank_counts_strictly_less(self):
        values = jnp.asarray([3.0, 1.0, 2.0, 2.0, np.nan, 5.0])
        assert int(rank.rank(values, 2.0)) == 1
        assert int(rank.rank(values, 2.5)) == 3

    def test_find_rank_matches_numpy_order_stat(self):
        rs = np.random.RandomState(seed=1)
        values = rs.uniform(0.01, 100.0, (13, 97)).astype(np.float32)
        for target in [0, 5, 48, 96]:
            out = rank.find_rank_float(jnp.asarray(values), target, False)
            expected = np.sort(values, axis=-1)[:, target]
            np.testing.assert_equal(np.asarray(out), expected)

    def test_find_rank_halfway(self):
        values = jnp.asarray([[1.0, 2.0, 3.0, 4.0]], jnp.float32)
        out = rank.find_rank_float(values, 2, True)
        np.testing.assert_allclose(np.asarray(out), [2.5])
        # With a tie at the target rank no averaging happens
        values = jnp.asarray([[1.0, 3.0, 3.0, 4.0]], jnp.float32)
        out = rank.find_rank_float(values, 2, True)
        np.testing.assert_allclose(np.asarray(out), [3.0])

    def test_find_rank_with_nan_padding(self):
        values = np.full((3, 16), np.nan, np.float32)
        rs = np.random.RandomState(seed=2)
        values[:, :11] = rs.uniform(0.1, 10.0, (3, 11))
        out = rank.find_rank_float(jnp.asarray(values), 5, False)
        expected = np.sort(values[:, :11], axis=-1)[:, 5]
        np.testing.assert_equal(np.asarray(out), expected)

    def test_median_non_zero_matches_numpy(self):
        rs = np.random.RandomState(seed=3)
        for n_nonzero in [5, 6, 50, 51]:
            values = np.zeros((2, 64), np.float32)
            values[:, :n_nonzero] = rs.uniform(0.1, 10.0, (2, n_nonzero))
            out = rank.median_non_zero(jnp.asarray(values))
            expected = np.median(values[:, :n_nonzero], axis=-1).astype(np.float32)
            np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-6)

    @pytest.mark.parametrize("radix_bits", [1, 3, 4, 8])
    def test_radix_widths_agree(self, radix_bits):
        """Every radix width must reproduce the binary search exactly."""
        rs = np.random.RandomState(seed=5)
        values = rs.uniform(1e-6, 1e6, (5, 203)).astype(np.float32)
        values[0, :50] = values[0, 0]  # heavy ties
        for target, halfway in [(0, False), (101, True), (202, False), (100, True)]:
            out = rank.find_rank_float(jnp.asarray(values), target, halfway,
                                       radix_bits=radix_bits)
            ref = rank.find_rank_float(jnp.asarray(values), target, halfway, radix_bits=1)
            np.testing.assert_equal(np.asarray(out), np.asarray(ref))

    @pytest.mark.parametrize("radix_bits", [1, 4])
    def test_axis0_search_matches_last_axis(self, radix_bits):
        """The straight-layout (axis=0) search is bit-identical to the
        transposed one, including halfway averaging, NaN padding, zeros."""
        rs = np.random.RandomState(seed=6)
        values = rs.uniform(0.01, 100.0, (203, 7)).astype(np.float32)
        values[:40, 0] = values[0, 0]  # ties
        values[150:, 2] = np.nan  # NaN padding
        values[:5, 3] = 0.0
        n = np.sum(~np.isnan(values), axis=0).astype(np.int32)
        for target, halfway in [(0, False), (101, True), (100, True)]:
            out = rank.find_rank_float(jnp.asarray(values), target, halfway,
                                       radix_bits=radix_bits, axis=0)
            ref = rank.find_rank_float(jnp.asarray(values.T), target, halfway,
                                       radix_bits=radix_bits)
            np.testing.assert_equal(np.asarray(out), np.asarray(ref))
        out = rank.median_non_zero(jnp.asarray(values), jnp.asarray(n), axis=0)
        ref = rank.median_non_zero(jnp.asarray(values.T), jnp.asarray(n))
        np.testing.assert_equal(np.asarray(out), np.asarray(ref))
        # Custom counting on the straight layout uses the AXIS-AWARE
        # contract count_fn(mask, axis) (see collectives.collective_count_axis).
        out = rank.find_rank_float(
            jnp.asarray(values), 101, True, axis=0, radix_bits=radix_bits,
            count_fn=lambda m, ax: m.sum(ax, dtype=jnp.int32),
            max_below_fn=lambda v, lim, ax: jnp.max(
                jnp.where(v < lim, v, 0.0), axis=ax),
        )
        ref = rank.find_rank_float(jnp.asarray(values.T), 101, True,
                                   radix_bits=radix_bits)
        np.testing.assert_equal(np.asarray(out), np.asarray(ref))

    @pytest.mark.parametrize("width", [3, 5, 9, 13])
    def test_selection_network_zero_one_principle(self, width):
        """The pruned median network places every output in 0..width//2
        correctly for all 2^width binary inputs (0-1 principle: min/max
        commute with thresholding, so this proves all inputs)."""
        outs = range(width // 2 + 1)
        net = rank.selection_network(width, outs)
        full_ops = 2 * len(rank.batcher_pairs(width))
        net_ops = sum(2 if k == "both" else 1 for (_, _, k) in net)
        assert net_ops < full_ops
        for bits in range(1 << width):
            v = [float((bits >> k) & 1) for k in range(width)]
            ref = sorted(v)
            w = list(v)
            for i, j, kind in net:
                a, b = w[i], w[j]
                if kind != "max":
                    w[i] = min(a, b)
                if kind != "min":
                    w[j] = max(a, b)
            assert [w[p] for p in outs] == [ref[p] for p in outs]

    @pytest.mark.parametrize("width", [3, 5, 9, 13])
    def test_selection_network_two_middle_ranks(self, width):
        """The parity-fill fast path's {width//2, width//2+1} network
        (greedy 0-1-pruned over the optimal base sort) is exact on all
        2^width binary inputs, and smaller than the lower-half network."""
        outs = (width // 2, width // 2 + 1)
        net = rank.selection_network(width, outs)
        lower = rank.selection_network(width, range(width // 2 + 1))
        ops_of = lambda n: sum(2 if k == "both" else 1 for (_, _, k) in n)
        assert ops_of(net) <= ops_of(lower)
        for bits in range(1 << width):
            v = [float((bits >> k) & 1) for k in range(width)]
            ref = sorted(v)
            w = list(v)
            for i, j, kind in net:
                a, b = w[i], w[j]
                if kind != "max":
                    w[i] = min(a, b)
                if kind != "min":
                    w[j] = max(a, b)
            assert [w[p] for p in outs] == [ref[p] for p in outs]

    def test_fmin_fmax(self):
        values = jnp.asarray([[np.nan, 2.0, 7.0, np.nan]], jnp.float32)
        np.testing.assert_equal(np.asarray(rank.fmin(values)), [2.0])
        np.testing.assert_equal(np.asarray(rank.fmax(values)), [7.0])
        all_nan = jnp.asarray([[np.nan, np.nan]], jnp.float32)
        assert np.isnan(np.asarray(rank.fmin(all_nan))).all()


class TestPercentile5:
    @pytest.mark.parametrize("engine", ["rank", "sort"])
    @pytest.mark.parametrize("is_amplitude", [True, False])
    @pytest.mark.parametrize("columns", [7, 241, 500])
    def test_vs_numpy(self, ctx, engine, is_amplitude, columns):
        rows = 37
        rs = np.random.RandomState(seed=1)
        if is_amplitude:
            src = rs.uniform(0.01, 100.0, (rows, columns)).astype(np.float32)
            amp = src
        else:
            src = complex_normal(rs, size=(rows, columns)).astype(np.complex64)
            amp = np.abs(src)
        template = percentile.Percentile5Template(
            ctx, columns, is_amplitude, tuning={"engine": engine}
        )
        op = template.instantiate(None, (rows, columns))
        out = np.asarray(op(src=jnp.asarray(src))["dest"])
        expected = np.r_[
            [np.min(amp, axis=1), np.max(amp, axis=1)],
            np.percentile(amp, [25, 75, 50], axis=1, method="lower").astype(np.float32),
        ]
        assert out.shape == (5, rows)
        if is_amplitude:
            np.testing.assert_equal(out, expected.astype(np.float32))
        else:
            # Amplitude computation may differ by 1 ulp from numpy's abs,
            # matching the reference's tolerance for complex input
            np.testing.assert_allclose(out, expected, rtol=1e-6)

    def test_column_range(self, ctx):
        rows, columns = 11, 100
        rs = np.random.RandomState(seed=1)
        src = rs.uniform(0.01, 100.0, (rows, columns)).astype(np.float32)
        template = percentile.Percentile5Template(ctx, columns, True)
        op = template.instantiate(None, (rows, columns), (13, 77))
        out = np.asarray(op(src=jnp.asarray(src))["dest"])
        sub = src[:, 13:77]
        np.testing.assert_equal(out[0], np.min(sub, axis=1))
        np.testing.assert_equal(
            out[4], np.percentile(sub, 50, axis=1, method="lower").astype(np.float32)
        )


class TestWgReduce:
    def test_named_ops(self):
        x = jnp.asarray([[1.0, np.nan, 3.0]], jnp.float32)
        np.testing.assert_allclose(np.asarray(wgreduce.reduce(x, wgreduce.fmax)), [3.0])
        np.testing.assert_allclose(np.asarray(wgreduce.reduce(x, wgreduce.fmin)), [1.0])
        y = jnp.asarray([[1.0, 2.0, 3.0]], jnp.float32)
        np.testing.assert_allclose(np.asarray(wgreduce.reduce(y, wgreduce.plus)), [6.0])
        np.testing.assert_allclose(np.asarray(wgreduce.reduce(y, wgreduce.max_)), [3.0])
        np.testing.assert_allclose(np.asarray(wgreduce.reduce(y, wgreduce.min_)), [1.0])


class TestWgScan:
    """Prefix-scan companion of the reduction library (ops.wgreduce.scan)."""

    def _data(self):
        rs = np.random.RandomState(seed=5)
        return rs.standard_normal((6, 40)).astype(np.float32)

    @pytest.mark.parametrize("reverse", [False, True])
    def test_plus_matches_numpy(self, reverse):
        x = self._data()
        out = np.asarray(wgreduce.scan(jnp.asarray(x), wgreduce.plus, axis=-1,
                                       reverse=reverse))
        exp = np.cumsum(x[:, ::-1], axis=-1)[:, ::-1] if reverse else np.cumsum(x, -1)
        np.testing.assert_allclose(exp, out, rtol=1e-5, atol=1e-5)  # tree vs serial assoc.

    def test_max_min(self):
        x = self._data()
        np.testing.assert_array_equal(
            np.maximum.accumulate(x, -1),
            np.asarray(wgreduce.scan(jnp.asarray(x), wgreduce.max_, axis=-1)))
        np.testing.assert_array_equal(
            np.minimum.accumulate(x, -1),
            np.asarray(wgreduce.scan(jnp.asarray(x), wgreduce.min_, axis=-1)))

    def test_exclusive(self):
        x = self._data()
        out = np.asarray(wgreduce.scan(jnp.asarray(x), wgreduce.plus, axis=-1,
                                       exclusive=True))
        exp = np.concatenate([np.zeros((x.shape[0], 1), x.dtype),
                              np.cumsum(x, -1)[:, :-1]], -1)
        np.testing.assert_allclose(exp, out, rtol=1e-5, atol=1e-5)

    def test_fmax_ignores_nan(self):
        x = self._data()
        x[:, 7] = np.nan
        x[2, :3] = np.nan
        out = np.asarray(wgreduce.scan(jnp.asarray(x), wgreduce.fmax, axis=-1))
        exp = np.fmax.accumulate(np.where(np.isnan(x), -np.inf, x), -1)
        exp = np.where(np.isinf(exp) & (exp < 0), np.nan, exp)
        np.testing.assert_array_equal(exp, out)

    def test_custom_operator(self):
        x = np.abs(self._data()) + 0.1
        mul = wgreduce.ReduceOp("prod", lambda a, b: a * b,
                                lambda dt: jnp.ones((), dt))
        out = np.asarray(wgreduce.scan(jnp.asarray(x), mul, axis=-1))
        np.testing.assert_allclose(np.cumprod(x, -1), out, rtol=1e-4)
