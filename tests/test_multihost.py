"""Multi-host helper tests (single-process semantics on the CPU mesh)."""

import jax
import pytest

from katsdpsigproc_tpu.parallel import mesh as pmesh, multihost


def test_initialize_single_host_noop():
    multihost.initialize(num_processes=1)  # must not raise


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
def test_pod_mesh_shapes():
    m = multihost.pod_mesh()
    assert m.shape[pmesh.BASELINE_AXIS] == jax.device_count()
    m2 = multihost.pod_mesh(channel_shards=2)
    assert m2.shape[pmesh.BASELINE_AXIS] == jax.device_count() // 2
    assert m2.shape[pmesh.CHANNEL_AXIS] == 2
    with pytest.raises(ValueError):
        multihost.pod_mesh(baseline_shards=3, channel_shards=2)


def test_process_summary():
    s = multihost.process_summary()
    assert "process 0/1" in s


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    """A real 2-process jax.distributed run: 2x2 (baseline x channel) global
    mesh across the process boundary, sharded-flagger mask parity vs the
    host oracle in each process (tests/multihost_worker.py)."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # pick a free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = pathlib.Path(__file__).parent / "multihost_worker.py"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(worker.parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "0 mismatches" in out, out


@pytest.mark.slow
def test_two_process_multichip_bench(tmp_path):
    """The scaling harness's --multihost path, launched exactly as it
    would be per host: a real 2-process jax.distributed run of
    scripts/multichip_bench.py over a 4-device global mesh (channel shards
    make the collectives cross the process boundary).  Coordinator-only
    JSON: process 0 emits the record with n_hosts == 2."""
    import json
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # pick a free port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    root = pathlib.Path(__file__).parent.parent
    script = root / "scripts" / "multichip_bench.py"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["KATSDPSIGPROC_TPU_PLATFORM"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        [f for f in env.get("XLA_FLAGS", "").split()
         if "xla_force_host_platform_device_count" not in f]
        + ["--xla_force_host_platform_device_count=2"])
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), "--multihost",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--channels", "2048", "--baselines", "32", "--iters", "2",
             "--channel-shards", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}\n{err}"
    recs = [json.loads(line) for line in outs[0][0].splitlines()
            if line.startswith("{")]
    assert len(recs) == 1, recs
    for r in recs:
        assert r["n_hosts"] == 2 and r["n_devices"] == 4, r
        assert 0.0 < r["value"], r
    # only the coordinator prints records
    assert not [line for line in outs[1][0].splitlines() if line.startswith("{")]
