"""chip_smoke.py's checks at tiny shapes on the CPU, its refusal to run off
a GPU, and — marked ``gpu`` — the same checks at the benchmark's shapes on
the card:

    KATSDPSIGPROC_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_chip_smoke.py -m gpu
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def small_dump():
    from katsdpsigproc_tpu.models.rfi import device

    vis = chip_smoke.make_dump(chip_smoke.SEED, 640, 40)
    flags = device.make_flagger_fn(13, 11.0, threshold="sum")(vis)
    return vis, flags


def test_make_dump_shape_and_spikes():
    vis = np.asarray(chip_smoke.make_dump(3, 256, 16))
    assert vis.shape == (256, 16, 2) and vis.dtype == np.float32
    spikes = (vis[..., 0] > 40).mean()
    assert 0.5 / 64 < spikes < 2 / 64
    np.testing.assert_array_equal(vis, np.asarray(chip_smoke.make_dump(3, 256, 16)))


@pytest.mark.parametrize("rows,n", [(8064, 64), (40, 64), (1, 64), (200, 7)])
def test_parity_columns(rows, n):
    cols = chip_smoke.parity_columns(rows, n)
    assert cols[0] == 0 and cols[-1] == rows - 1
    assert len(cols) == min(n, rows) and (np.diff(cols) > 0).all()


def test_flagger_vs_host(small_dump):
    vis, flags = small_dump
    cols = chip_smoke.parity_columns(40, 64)
    assert chip_smoke.check_flagger_vs_host(vis, flags, cols) == 640 * 40


def test_flagger_vs_host_detects_a_flip(small_dump):
    vis, flags = small_dump
    bad = flags.at[5, 3].set(1 - flags[5, 3])
    with pytest.raises(chip_smoke.SmokeFailure, match="1 of"):
        chip_smoke.check_flagger_vs_host(vis, bad, np.array([3]))


def test_blocked_matches_unblocked(small_dump):
    from katsdpsigproc_tpu.models.rfi import device

    vis, flags = small_dump
    blocked = device.make_flagger_fn(13, 11.0, threshold="sum", baseline_block=16)(vis)
    assert chip_smoke.check_flags_equal(blocked, flags, "blocked") == flags.size
    with pytest.raises(chip_smoke.SmokeFailure, match="flags differ"):
        chip_smoke.check_flags_equal(blocked.at[0, 0].add(1), flags, "blocked")


def test_twodflag():
    assert chip_smoke.check_twodflag((60, 128, 2)) == 60 * 128 * 2


@pytest.mark.parametrize("engine", ["rank", "sort"])
def test_percentile(engine):
    chip_smoke.check_percentile(16, 301, engine)


@pytest.mark.parametrize("use_amplitudes", [False, True])
def test_maskedsum(use_amplitudes):
    assert chip_smoke.check_maskedsum(512, 16, use_amplitudes) <= chip_smoke.MASKEDSUM_RTOL


def test_transpose():
    chip_smoke.check_transpose(96, 160)


def test_spectral_flag():
    assert chip_smoke.check_spectral_flag(14, 2048) == 14 * 1025


def test_strict_tuning_refuses_a_miss(monkeypatch):
    from katsdpsigproc_tpu.ops import percentile
    from katsdpsigproc_tpu.utils import tune

    monkeypatch.setattr(tune, "_device_columns",
                        lambda: {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"})
    with chip_smoke.strict_tuning():
        with pytest.raises(chip_smoke.SmokeFailure, match="live search"):
            percentile.Percentile5Template(None, 4999, True)
    assert tune.autotuner_impl is not None


def test_tuned_choices_resolve_on_the_card(monkeypatch, tmp_path):
    """Every autotuned template resolves from the shipped table for the
    card the table was measured on, with no live search."""
    from katsdpsigproc_tpu.utils import tune

    monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "empty.json"))
    monkeypatch.setattr(tune, "_device_columns",
                        lambda: {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"})
    choices = chip_smoke.tuned_choices(None)
    assert choices["percentile5_engine"] in ("rank", "sort")
    assert choices["background_engine"] in ("network", "count")


def test_four_cards_on_virtual_devices():
    """The --four-cards path: the channel-sharded flagger on a 4-device
    mesh of the test's virtual CPU devices against one device."""
    assert jax.device_count() >= 4
    assert chip_smoke.four_cards("cpu", channels=512, rows=24) == 512 * 24


def test_refuses_cpu():
    """Off a GPU the script exits non-zero and prints no result."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


@pytest.mark.gpu
class TestOnTheCard:
    """The same checks at the benchmark's shapes (section 4 of chip_smoke)."""

    def test_flagger_full_width(self):
        from katsdpsigproc_tpu.models.rfi import device

        vis = chip_smoke.make_dump(chip_smoke.SEED, chip_smoke.CHANNELS, chip_smoke.ROWS)
        flags = device.make_flagger_fn(13, 11.0, threshold="sum")(vis)
        chip_smoke.check_flagger_vs_host(vis, flags, chip_smoke.parity_columns(chip_smoke.ROWS))
        blocked = device.make_flagger_fn(13, 11.0, threshold="sum",
                                         baseline_block=chip_smoke.SLAB)(vis)
        chip_smoke.check_flags_equal(blocked, flags, "blocked vs unblocked")

    def test_twodflag(self):
        chip_smoke.check_twodflag((3000, 1024, 1))

    @pytest.mark.parametrize("engine", ["rank", "sort"])
    def test_percentile(self, engine):
        chip_smoke.check_percentile(4000, 5000, engine)

    @pytest.mark.parametrize("use_amplitudes", [False, True])
    def test_maskedsum(self, use_amplitudes):
        chip_smoke.check_maskedsum(4096, 64, use_amplitudes)

    def test_transpose(self):
        chip_smoke.check_transpose(8192, 2016)

    def test_spectral_flag(self):
        chip_smoke.check_spectral_flag(256, 32768)
