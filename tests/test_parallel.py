"""Multi-device tests on the virtual 8-device CPU mesh.

The oracle pattern extends to shards (SURVEY.md §4 "Multi-node testing"):
the sharded collective result must equal the single-device result on the
gathered data, and the sharded flagger must match the host flagger
mask-for-mask.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from katsdpsigproc_tpu.models.rfi import device as rfi_device, host as rfi_host
from katsdpsigproc_tpu.ops import percentile as percentile_ops, rank as rank_ops
from katsdpsigproc_tpu.parallel import collectives, flagger as pflagger, mesh as pmesh

from .helpers import rfi_test_data

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture
def mesh_1d():
    return pmesh.make_mesh((8,), (pmesh.BASELINE_AXIS,))


@pytest.fixture
def mesh_2d():
    return pmesh.make_mesh((2, 4), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))


@pytest.fixture
def mesh_channel():
    return pmesh.make_mesh((1, 8), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))


class TestCollectiveRank:
    def test_find_rank_matches_local(self, mesh_channel):
        rs = np.random.RandomState(seed=1)
        values = rs.uniform(0.01, 100.0, (16, 512)).astype(np.float32)

        def fn(v):
            return collectives.find_rank_float(v, 100, False, pmesh.CHANNEL_AXIS)

        sharded = shard_map(
            fn, mesh=mesh_channel, in_specs=P(None, pmesh.CHANNEL_AXIS), out_specs=P(None),
            check_vma=False,
        )
        out = jax.jit(sharded)(jnp.asarray(values))
        expected = rank_ops.find_rank_float(jnp.asarray(values), 100, False)
        np.testing.assert_equal(np.asarray(out), np.asarray(expected))
        np.testing.assert_equal(np.asarray(out), np.sort(values, axis=-1)[:, 100])

    def test_find_rank_straight_layout(self, mesh_channel):
        """Straight-layout (axis=0) sharded rank search: the channel axis is
        sharded WITHOUT a corner turn (VERDICT round-1 item 10)."""
        rs = np.random.RandomState(seed=21)
        values = rs.uniform(0.01, 100.0, (512, 16)).astype(np.float32)  # (chan, bl)

        def fn(v):
            return collectives.find_rank_float(
                v, 100, True, pmesh.CHANNEL_AXIS, axis=0)

        sharded = shard_map(
            fn, mesh=mesh_channel, in_specs=P(pmesh.CHANNEL_AXIS, None),
            out_specs=P(None), check_vma=False,
        )
        out = jax.jit(sharded)(jnp.asarray(values))
        expected = rank_ops.find_rank_float(jnp.asarray(values), 100, True, axis=0)
        np.testing.assert_equal(np.asarray(out), np.asarray(expected))

    def test_median_non_zero_matches_local(self, mesh_channel):
        rs = np.random.RandomState(seed=2)
        values = rs.uniform(0.01, 10.0, (8, 256)).astype(np.float32)
        values[:, rs.random_sample(256) < 0.2] = 0.0

        def fn(v):
            return collectives.median_non_zero(v, 256, pmesh.CHANNEL_AXIS)

        sharded = shard_map(
            fn, mesh=mesh_channel, in_specs=P(None, pmesh.CHANNEL_AXIS), out_specs=P(None),
            check_vma=False,
        )
        out = np.asarray(jax.jit(sharded)(jnp.asarray(values)))
        for i in range(values.shape[0]):
            nz = values[i][values[i] > 0]
            np.testing.assert_allclose(out[i], np.median(nz), rtol=1e-6)

    def test_percentile5_matches_local(self, mesh_channel):
        rs = np.random.RandomState(seed=3)
        values = rs.uniform(0.01, 100.0, (8, 488)).astype(np.float32)

        def fn(v):
            return collectives.percentile5(v, 488, pmesh.CHANNEL_AXIS)

        sharded = shard_map(
            fn, mesh=mesh_channel, in_specs=P(None, pmesh.CHANNEL_AXIS), out_specs=P(None, None),
            check_vma=False,
        )
        out = np.asarray(jax.jit(sharded)(jnp.asarray(values)))
        expected = np.asarray(percentile_ops.percentile5(jnp.asarray(values)))
        np.testing.assert_equal(out, expected)


class TestHaloExchange:
    def test_halo_rows(self, mesh_channel):
        x = np.arange(64, dtype=np.float32).reshape(64, 1)

        def fn(v):
            return collectives.halo_exchange(v, 2, pmesh.CHANNEL_AXIS, jnp.nan, axis=0)

        sharded = shard_map(
            fn,
            mesh=mesh_channel,
            in_specs=P(pmesh.CHANNEL_AXIS, None),
            out_specs=P(pmesh.CHANNEL_AXIS, None),
            check_vma=False,
        )
        out = np.asarray(jax.jit(sharded)(jnp.asarray(x)))  # (8 shards × 12 rows, 1)
        blocks = out.reshape(8, 12, 1)
        # First shard: NaN pad on the left, rows 0..7, then neighbour rows 8,9
        assert np.isnan(blocks[0, :2]).all()
        np.testing.assert_equal(blocks[0, 2:10, 0], np.arange(8))
        np.testing.assert_equal(blocks[0, 10:, 0], [8, 9])
        # Middle shard 3: left halo 22,23 then 24..31 then 32,33
        np.testing.assert_equal(blocks[3, :, 0], np.arange(22, 34))
        # Last shard: right pad NaN
        assert np.isnan(blocks[7, -2:]).all()
        np.testing.assert_equal(blocks[7, :10, 0], np.arange(54, 64))


class TestShardedFlagger:
    @pytest.mark.parametrize("mesh_name", ["mesh_1d", "mesh_2d", "mesh_channel"])
    @pytest.mark.parametrize("threshold", ["simple", "sum"])
    def test_matches_host(self, request, mesh_name, threshold):
        mesh = request.getfixturevalue(mesh_name)
        # Shapes divisible by the mesh axes
        vis, spikes, _ = rfi_test_data(shape=(256, 64), seed=5)
        fn = pflagger.make_sharded_flagger(mesh, width=13, n_sigma=11.0, threshold=threshold)
        out = np.asarray(fn(jnp.asarray(vis)))

        host_threshold = (
            rfi_host.ThresholdSimpleHost(11.0)
            if threshold == "simple"
            else rfi_host.ThresholdSumHost(11.0)
        )
        host_flagger = rfi_host.FlaggerHost(
            rfi_host.BackgroundMedianFilterHost(13), rfi_host.NoiseEstMADHost(), host_threshold
        )
        expected = host_flagger(vis)
        np.testing.assert_equal(out, expected)

    @pytest.mark.parametrize("mesh_name", ["mesh_1d", "mesh_2d", "mesh_channel"])
    def test_baseline_block_matches_unblocked(self, request, mesh_name):
        """Per-shard baseline blocking (scan) is bit-identical, collectives
        aligned across blocks."""
        mesh = request.getfixturevalue(mesh_name)
        vis, _, _ = rfi_test_data(shape=(256, 64), seed=5)
        plain = pflagger.make_sharded_flagger(mesh, width=13, n_sigma=11.0)
        blocked = pflagger.make_sharded_flagger(
            mesh, width=13, n_sigma=11.0, baseline_block=8
        )
        np.testing.assert_equal(
            np.asarray(blocked(jnp.asarray(vis))), np.asarray(plain(jnp.asarray(vis)))
        )

    def test_with_channel_flags(self, mesh_2d):
        vis, spikes, input_flags = rfi_test_data(shape=(256, 64), seed=6)
        fn = pflagger.make_sharded_flagger(
            mesh_2d, width=13, n_sigma=11.0,
            use_flags=rfi_device.BackgroundFlags.CHANNEL, threshold="simple",
        )
        out = np.asarray(fn(jnp.asarray(vis), jnp.asarray(input_flags[:, 0])))
        host_flagger = rfi_host.FlaggerHost(
            rfi_host.BackgroundMedianFilterHost(13),
            rfi_host.NoiseEstMADHost(),
            rfi_host.ThresholdSimpleHost(11.0),
        )
        expected = host_flagger(vis, input_flags[:, 0])
        np.testing.assert_equal(out, expected)

    def test_with_full_flags(self, mesh_2d):
        vis, spikes, input_flags = rfi_test_data(shape=(256, 64), seed=8)
        fn = pflagger.make_sharded_flagger(
            mesh_2d, width=13, n_sigma=11.0,
            use_flags=rfi_device.BackgroundFlags.FULL, threshold="sum",
        )
        out = np.asarray(fn(jnp.asarray(vis), jnp.asarray(input_flags)))
        host_flagger = rfi_host.FlaggerHost(
            rfi_host.BackgroundMedianFilterHost(13),
            rfi_host.NoiseEstMADHost(),
            rfi_host.ThresholdSumHost(11.0),
        )
        np.testing.assert_equal(out, host_flagger(vis, input_flags))

    def test_planar_input(self, mesh_2d):
        vis, _, _ = rfi_test_data(shape=(256, 64), seed=9)
        fn = pflagger.make_sharded_flagger(mesh_2d, width=13, n_sigma=11.0, threshold="sum")
        out_c = np.asarray(fn(jnp.asarray(vis)))
        out_p = np.asarray(fn(jnp.asarray(rfi_device.to_planar(vis))))
        np.testing.assert_equal(out_c, out_p)

    def test_amplitude_input(self, mesh_1d):
        vis, _, _ = rfi_test_data(shape=(256, 64), seed=10)
        amp = np.abs(vis).astype(np.float32)
        fn = pflagger.make_sharded_flagger(
            mesh_1d, width=13, n_sigma=11.0, is_amplitude=True, threshold="simple"
        )
        out = np.asarray(fn(jnp.asarray(amp)))
        host_flagger = rfi_host.FlaggerHost(
            rfi_host.BackgroundMedianFilterHost(13, amplitudes=True),
            rfi_host.NoiseEstMADHost(),
            rfi_host.ThresholdSimpleHost(11.0),
        )
        np.testing.assert_equal(out, host_flagger(amp))

    def test_flag_arg_validation(self, mesh_1d):
        fn = pflagger.make_sharded_flagger(mesh_1d)
        with pytest.raises(TypeError):
            fn(jnp.zeros((16, 8), jnp.complex64), jnp.zeros(16, jnp.uint8))


@pytest.mark.slow
class TestShardedTwodflag:
    """Sharded 2-D flagger matches the single-device path bit-for-bit."""

    def _data(self, n_bl):
        rs = np.random.RandomState(seed=3)
        shape = (32, 96, n_bl)
        data = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(
            np.complex64
        )
        data[10, :, :] *= 20.0  # planted RFI
        flags = np.zeros(shape, np.bool_)
        flags[:, 5, :] = True
        return data, flags

    def test_matches_unsharded(self, mesh_1d):
        from katsdpsigproc_tpu.models.rfi import twodflag

        data, flags = self._data(16)
        flagger = twodflag.SumThresholdFlagger(freq_chunks=4)
        expected = flagger.get_flags(data, flags)
        out = flagger.get_flags_sharded(data, flags, mesh_1d)
        np.testing.assert_array_equal(expected, out)

    def test_pads_uneven_baselines(self, mesh_1d):
        from katsdpsigproc_tpu.models.rfi import twodflag

        data, flags = self._data(11)  # not a multiple of 8
        flagger = twodflag.SumThresholdFlagger(freq_chunks=4)
        expected = flagger.get_flags(data, flags)
        out = flagger.get_flags_sharded(data, flags, mesh_1d)
        assert out.shape == expected.shape
        np.testing.assert_array_equal(expected, out)


class TestFourDeviceChannelMesh:
    """The four-card layout (chip_smoke.py --four-cards): channels sharded
    over a 4-device mesh, flags identical to the one-device flagger."""

    @pytest.mark.parametrize("use_flags", list(rfi_device.BackgroundFlags))
    def test_matches_one_device(self, use_flags):
        from jax.sharding import NamedSharding

        mesh = pmesh.make_mesh((1, 4), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS))
        vis, _, input_flags = rfi_test_data(shape=(512, 24), seed=9)
        planar = rfi_device.to_planar(vis)
        vis_sharded = jax.device_put(
            jnp.asarray(planar),
            NamedSharding(mesh, P(pmesh.CHANNEL_AXIS, pmesh.BASELINE_AXIS, None)))
        args, args_1 = (vis_sharded,), (jnp.asarray(planar),)
        if use_flags == rfi_device.BackgroundFlags.CHANNEL:
            flags = jnp.asarray(input_flags[:, 0].astype(np.uint8))
            args, args_1 = args + (flags,), args_1 + (flags,)
        elif use_flags == rfi_device.BackgroundFlags.FULL:
            flags = jnp.asarray(input_flags.astype(np.uint8))
            args, args_1 = args + (flags,), args_1 + (flags,)
        sharded = pflagger.make_sharded_flagger(mesh, width=13, n_sigma=11.0,
                                                use_flags=use_flags)
        out = sharded(*args)
        assert len({s.device for s in out.addressable_shards}) == 4
        single = rfi_device.make_flagger_fn(13, 11.0, use_flags=use_flags)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(single(*args_1)))
