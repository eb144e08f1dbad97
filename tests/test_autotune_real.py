"""End-to-end autotune searches (reference: per-op @force_autotune tests,
e.g. test/test_transpose.py:61-63)."""

import pytest


@pytest.mark.force_autotune
@pytest.mark.slow
def test_percentile_autotune_real_search(patch_autotune, tmp_path, monkeypatch):
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "t.json"))
    from katsdpsigproc_tpu.ops import percentile
    from katsdpsigproc_tpu.utils import backend

    ctx = backend.create_some_context()
    template = percentile.Percentile5Template(ctx, 64, True)
    assert template.engine in ("rank", "sort")


@pytest.mark.force_autotune
def test_background_engine_autotune_real_search(patch_autotune, tmp_path, monkeypatch):
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "t.json"))
    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.utils import backend

    ctx = backend.create_some_context()
    template = device.BackgroundMedianFilterDeviceTemplate(ctx, 5)
    assert template.engine in ("network", "count")


@pytest.mark.force_autotune
@pytest.mark.slow
def test_madnz_radix_autotune_real_search(patch_autotune, tmp_path, monkeypatch):
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "t.json"))
    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.utils import backend, tune

    ctx = backend.create_some_context()
    orig = tune.autotune

    def narrowed(generate, **kwargs):
        return orig(generate, radix_bits=[1, 4])

    monkeypatch.setattr(tune, "autotune", narrowed)
    template = device.NoiseEstMADTDeviceTemplate(ctx, max_channels=2048)
    assert template.radix_bits in (1, 4)
