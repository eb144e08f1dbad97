"""Smoke tests for the benchmark scripts (reference: scripts/*.py drivers)."""

import os
import pathlib
import subprocess
import sys

import pytest

SCRIPTS = pathlib.Path(__file__).parent.parent / "scripts"


def _run(script, *args):
    env = dict(os.environ)
    env["KATSDPSIGPROC_TPU_PLATFORM"] = "cpu"
    env["KATSDPSIGPROC_TPU_TUNE_DB"] = "/tmp/test_scripts_tune.json"
    return subprocess.run(
        [sys.executable, str(SCRIPTS / script), *args],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
        cwd=str(SCRIPTS.parent),
    )


def test_rfiflagtest_1d():
    r = _run("rfiflagtest.py", "--channels", "256", "--baselines", "32")
    assert r.returncode == 0, r.stderr
    assert "Mask mismatches: 0" in r.stderr


@pytest.mark.slow
def test_rfiflagtest_2d():
    r = _run("rfiflagtest.py", "--time", "48", "--channels", "300", "--baselines", "2")
    assert r.returncode == 0, r.stderr
    assert "2-D flagger" in r.stderr


def test_transposetest():
    r = _run("transposetest.py", "--rows", "96", "--cols", "160", "--iters", "2")
    assert r.returncode == 0, r.stderr


def test_percentiletest():
    r = _run("percentiletest.py", "--rows", "64", "--cols", "100", "--iters", "2")
    assert r.returncode == 0, r.stderr
    assert "exact match" in r.stderr


@pytest.mark.parametrize("amplitudes", [False, True])
def test_maskedsumtest(amplitudes):
    args = ["--rows", "64", "--cols", "100", "--iters", "2"]
    if amplitudes:
        args.append("--amplitudes")
    r = _run("maskedsumtest.py", *args)
    assert r.returncode == 0, r.stderr


def test_maskedsumabstest_alias():
    r = _run("maskedsumabstest.py", "--rows", "64", "--cols", "100", "--iters", "2")
    assert r.returncode == 0, r.stderr


def test_fftflagtest():
    r = _run("fftflagtest.py", "--baselines", "14", "--channels", "1024", "--iters", "2")
    assert r.returncode == 0, r.stderr
    assert "agree with np.fft" in r.stderr


@pytest.mark.parametrize("script", ["tune_all.py", "flagger_trace.py", "multichip_bench.py"])
def test_help(script):
    """The GPU-side scripts parse their options without touching a device."""
    r = _run(script, "--help")
    assert r.returncode == 0, r.stderr
    assert "usage" in r.stdout


def test_api_index_fresh():
    r = _run("gen_api_index.py", "--check")
    assert r.returncode == 0, r.stderr


@pytest.mark.slow
def test_multichip_bench():
    """The multi-device scaling harness runs end-to-end on the CPU mesh."""
    import json

    r = _run("multichip_bench.py", "--channels", "512", "--baselines", "64",
             "--iters", "2", "--channel-shards", "2")
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout + r.stderr
    rec = json.loads(lines[0])
    assert rec["metric"] == "multichip_scaling_efficiency"
    assert rec["n_devices"] == 8
    assert 0 < rec["value"] < 10


def test_flagger_trace_cpu(tmp_path):
    """The stage-trace reduction attributes every kernel of a small CPU
    trace to a named flagger stage."""
    import json

    r = _run("flagger_trace.py", "--rows", "8", "--channels", "512", "--dumps", "1",
             "--out", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    stages = rec["stages"]
    assert rec["platform"] == "cpu"
    for stage in ("background_median_filter", "madnz", "threshold_sum"):
        assert stages[stage]["device_seconds_per_dump"] > 0, stages
        assert stages[stage]["bytes_per_vis"] > 0, stages
    assert (tmp_path / "flagger.hlo.txt").exists()
