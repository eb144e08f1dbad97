"""Tests for bench.py: the peak table, the timing record, and the cells at
tiny shapes.  A CPU is not a benchmark device, so ``bench.py`` itself
refuses to run here; the cells are called in-process with an explicit
peak bandwidth instead."""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402


def _args(**kw):
    base = dict(channels=512, baselines=64, pols=1, width=13, iters=2, slab=32,
                skip_parity=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _check_records(recs):
    for rec in recs:
        json.dumps(rec)
        assert set(rec) >= {"metric", "value", "unit", "vs_baseline", "seconds"}, rec
        assert rec["value"] > 0
        assert rec["seconds_min"] <= rec["seconds"] <= rec["seconds_max"]
    return recs


def test_peak_table_h100():
    assert bench.peak_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_is_error(kind):
    with pytest.raises(ValueError, match="no published peak bandwidth"):
        bench.peak_hbm_gbps(kind)


def test_refuses_cpu():
    """No CPU fallback: the CPU has no peak-table entry, so bench.py exits
    non-zero before printing any record."""
    env = dict(os.environ)
    env["KATSDPSIGPROC_TPU_PLATFORM"] = "cpu"
    r = subprocess.run([sys.executable, str(ROOT / "bench.py")], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no published peak bandwidth for device kind 'cpu'" in r.stderr


def test_timing_record():
    t = bench.timing(lambda x: x + 1, jnp.ones(8), iters=5)
    assert t["iters"] == 5
    assert t["seconds_min"] <= t["seconds_q1"] <= t["seconds"] <= t["seconds_q3"] \
        <= t["seconds_max"]


@pytest.mark.slow
def test_headline_small(capsys):
    (rec,) = _check_records(bench.bench_flagger(_args(), hbm_gbps=1.0))
    assert rec["metric"] == "rfi_flagger_visibilities_per_second_per_chip"
    assert "parity" in capsys.readouterr().err  # mask-parity check ran
    assert rec["pols"] == 1 and rec["rows"] == 64
    assert "onepol" not in rec  # side record only for pol-flattened dumps
    assert rec["measured_copy_gbps"] > 0


@pytest.mark.slow
def test_headline_pols():
    """--pols flattens polarizations into baseline rows (config 5's 4-pol
    shape); the record carries the flattening and the 1-pol side record."""
    (rec,) = _check_records(bench.bench_flagger(
        _args(baselines=32, pols=2, skip_parity=True), hbm_gbps=1.0))
    assert rec["pols"] == 2 and rec["rows"] == 64
    assert rec["onepol"]["rows"] == 32
    assert rec["onepol"]["vis_per_second"] > 0


@pytest.mark.slow
def test_config2(patch_autotune):
    recs = _check_records(bench.bench_config2(_args(), hbm_gbps=1.0))
    assert {rec["metric"] for rec in recs} == {
        "percentile5_64x4k_elements_per_second",
        "maskedsum_4kx64_elements_per_second",
    }
