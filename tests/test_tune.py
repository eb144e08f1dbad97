"""Tests for the static tuning table (reference: test/test_tune.py patterns)."""

import json

import numpy as np
import pytest

from katsdpsigproc_tpu.utils import tune


class TestAutotune:
    def test_picks_best(self):
        scores = {1: 0.5, 2: 0.1, 3: 0.9}

        def generate(x):
            return lambda iters: scores[x]

        assert tune.autotune(generate, x=[1, 2, 3]) == {"x": 2}

    def test_skips_exceptions(self):
        def generate(x):
            if x == 2:
                raise RuntimeError("bad config")
            return lambda iters: float(x)

        assert tune.autotune(generate, x=[2, 1, 3]) == {"x": 1}

    def test_raises_if_all_fail(self):
        def generate(x):
            raise RuntimeError(f"bad {x}")

        with pytest.raises(RuntimeError, match="bad 3"):
            tune.autotune(generate, x=[1, 2, 3])

    def test_product_space(self):
        def generate(a, b):
            return lambda iters: a * 10 + b

        assert tune.autotune(generate, a=[1, 2], b=[3, 1]) == {"a": 1, "b": 1}


class _FakeOp:
    autotune_version = 3

    @classmethod
    @tune.autotuner(test={"wgs": 64})
    def autotune(cls, context, size):
        cls.ran = True
        return {"wgs": size * 2}


class TestAutotunerTable:
    def test_miss_runs_and_caches(self, tmp_path, monkeypatch):
        db = tmp_path / "tuning.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(db))
        _FakeOp.ran = False
        result = _FakeOp.autotune(None, 8)
        assert result == {"wgs": 16}
        assert _FakeOp.ran
        # Second call hits the cache
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert not _FakeOp.ran
        records = json.loads(db.read_text())
        assert len(records) == 1
        assert records[0]["version"] == 3

    def test_different_args_miss(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "t.json"))
        _FakeOp.autotune(None, 8)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 16) == {"wgs": 32}
        assert _FakeOp.ran

    def test_nearest_match_ignores_device(self, tmp_path, monkeypatch):
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(db))
        _FakeOp.autotune(None, 8)
        records = json.loads(db.read_text())
        records[0]["device_kind"] = "some other chip"
        db.write_text(json.dumps(records))
        _FakeOp.ran = False
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_MATCH", "nearest")
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert not _FakeOp.ran
        # Exact matching requires the device to match
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_MATCH", "exact")
        _FakeOp.autotune(None, 8)
        assert _FakeOp.ran

    def test_nearest_match_unknown_device_kind_warns(self, tmp_path, monkeypatch, caplog):
        """A device model the table has never seen (of a platform it has
        records for) inherits the nearest record — with a logged warning,
        so the silent-inheritance failure mode is at least visible
        (reference semantics: tune.py:151-199)."""
        import logging

        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(db))
        _FakeOp.autotune(None, 8)  # record under the real device columns
        records = json.loads(db.read_text())
        assert records[0]["device_kind"] != "Future Accelerator 9"

        from katsdpsigproc_tpu.utils import backend

        platform = records[0]["platform"]
        monkeypatch.setattr(backend, "device_kind_key",
                            lambda: (platform, "Future Accelerator 9"))
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_MATCH", "nearest")
        _FakeOp.ran = False
        with caplog.at_level(logging.WARNING, logger="katsdpsigproc_tpu.utils.tune"):
            assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert not _FakeOp.ran  # inherited, no live search
        assert any("inherited" in r.message and "Future Accelerator 9" in r.message
                   for r in caplog.records)
        # exact matching refuses the foreign record and re-tunes instead
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_MATCH", "exact")
        _FakeOp.autotune(None, 8)
        assert _FakeOp.ran

    @pytest.mark.parametrize("match", ["nearest", "exact"])
    def test_never_inherits_across_platforms(self, tmp_path, monkeypatch, match):
        """A record measured on another platform names engines this
        backend may not compile, so even ``nearest`` refuses it and the
        search runs instead."""
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(db))
        _FakeOp.autotune(None, 8)
        records = json.loads(db.read_text())
        records[0]["platform"] = "other-platform"
        records[0]["result"] = {"wgs": 999}
        db.write_text(json.dumps(records))
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_MATCH", match)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert _FakeOp.ran

    def test_fetch_drops_only_device_kind(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "none.json"))
        monkeypatch.setattr(tune, "_TABLE_PATH", str(tmp_path / "table.json"))
        (tmp_path / "table.json").write_text(json.dumps([
            {"fn": "f", "version": 1, "args": "{}", "platform": "gpu",
             "device_kind": "A", "result": {"engine": "a"}},
            {"fn": "f", "version": 1, "args": "{}", "platform": "cpu",
             "device_kind": "cpu", "result": {"engine": "c"}},
        ]))
        keys = {"fn": "f", "version": 1, "args": "{}"}
        assert tune._fetch({**keys, "platform": "gpu", "device_kind": "A"}) == {"engine": "a"}
        assert tune._fetch({**keys, "platform": "gpu", "device_kind": "B"}) == {"engine": "a"}
        assert tune._fetch({**keys, "platform": "rocm", "device_kind": "A"}) is None
        assert tune._fetch({**keys, "platform": "gpu", "device_kind": "A",
                            "version": 2}) is None

    def test_stub(self, monkeypatch):
        monkeypatch.setattr(tune, "autotuner_impl", tune.stub_autotuner)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 64}
        assert not _FakeOp.ran

    def test_stub_env(self, tmp_path, monkeypatch):
        """KATSDPSIGPROC_TPU_TUNE_STUB stubs table MISSES across process
        boundaries (subprocess CLI smoke tests) — but a table hit still
        wins, and nothing is written to the cache."""
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(db))
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_STUB", "1")
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 64}  # decorator test= value
        assert not _FakeOp.ran
        assert not db.exists()  # stubbed results are never persisted

    def test_force(self, tmp_path, monkeypatch):
        db = tmp_path / "t.json"
        monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(db))
        _FakeOp.autotune(None, 8)  # populate cache
        monkeypatch.setattr(tune, "autotuner_impl", tune.force_autotuner)
        _FakeOp.ran = False
        assert _FakeOp.autotune(None, 8) == {"wgs": 16}
        assert _FakeOp.ran  # cache bypassed


class TestMakeMeasure:
    def test_measures(self):
        import jax.numpy as jnp

        calls = []

        def fn():
            calls.append(1)
            return jnp.ones(8)

        measure = tune.make_measure(fn, warmup=1)
        elapsed = measure(3)
        assert elapsed >= 0
        assert len(calls) == 4  # 1 warmup + 3 timed


def test_patch_autotune_fixture(patch_autotune):
    """The pytest plugin stubs autotuning (no table I/O, no measurement)."""
    _FakeOp.ran = False
    assert _FakeOp.autotune(None, 8) == {"wgs": 64}
    assert not _FakeOp.ran


@pytest.mark.force_autotune
def test_force_autotune_mark(patch_autotune, tmp_path, monkeypatch):
    monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "t.json"))
    _FakeOp.ran = False
    assert _FakeOp.autotune(None, 4) == {"wgs": 8}
    assert _FakeOp.ran


def test_adapt_value():
    """Reference tune.py:93-104 key adaptation."""
    import enum

    import numpy as np

    from katsdpsigproc_tpu.utils import tune

    class Color(enum.Enum):
        RED = 1

    assert tune.adapt_value(np.dtype(np.float32)) == repr(np.dtype(np.float32))
    assert tune.adapt_value(int) == repr(int)
    assert tune.adapt_value(Color.RED) == "RED"
    assert tune.adapt_value(42) == 42


#: The device the shipped table is measured on (scripts/tune_all.py).
SHIPPED_DEVICE = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"}


def test_shipped_table_covers_every_template(tmp_path, monkeypatch):
    """Instantiating any autotuned template on the shipped table's device
    must resolve from the SHIPPED table — a missing record silently falls
    through to a LIVE measured search.  The user cache is pointed at an
    empty path so a machine-local record cannot mask a gap in the shipped
    table, and the device columns are those of the card the table was
    measured on (records never cross platforms, so on this test's CPU
    they would all miss)."""
    from katsdpsigproc_tpu.models.rfi import device as rfi_device
    from katsdpsigproc_tpu.ops import percentile
    from katsdpsigproc_tpu.utils import backend, tune

    monkeypatch.setenv("KATSDPSIGPROC_TPU_TUNE_DB", str(tmp_path / "empty.json"))
    monkeypatch.setattr(tune, "_device_columns", lambda: dict(SHIPPED_DEVICE))

    def strict_impl(test, fn, *args, **kwargs):
        cls = args[0] if args else None
        keys = tune._keys(fn, args, kwargs)
        keys["version"] = getattr(cls, "autotune_version", 0)
        keys.update(tune._device_columns())
        cached = tune._fetch(keys)
        assert cached is not None, f"no shipped tuning record for {keys}"
        return cached

    monkeypatch.setattr(tune, "autotuner_impl", strict_impl)
    ctx = backend.create_some_context()
    percentile.Percentile5Template(ctx, 5000, True)
    rfi_device.BackgroundMedianFilterDeviceTemplate(ctx, 13)
    rfi_device.NoiseEstMADTDeviceTemplate(ctx)
    rfi_device.NoiseEstMADDeviceTemplate(ctx)


def test_shipped_table_versions_match_code():
    """Millisecond-fast JSON check: every template's ``autotune_version``
    has a same-version record in the SHIPPED table.  ``_fetch`` matches on
    'version' and never relaxes it, so a version bump without a table
    refresh silently degrades to a live measured search or, under
    KATSDPSIGPROC_TPU_TUNE_STUB, to the test config."""
    import json
    import os

    from katsdpsigproc_tpu.models.rfi import device as rfi_device
    from katsdpsigproc_tpu.ops import percentile
    from katsdpsigproc_tpu.utils import tune

    table = json.load(open(os.path.join(os.path.dirname(tune.__file__),
                                        "tuning_table.json")))
    by_fn = {}
    for rec in table:
        by_fn.setdefault(rec["fn"], set()).add(rec["version"])
    # Canonical production instantiations: the args each template's
    # default construction binds (derived through tune._keys so the JSON
    # canonicalization cannot drift from the lookup path).  A same-version
    # record at a DIFFERENT args granularity would keep the version check
    # green while production still falls through to a live search.
    canonical = [
        (percentile.Percentile5Template, (5000, True)),
        (rfi_device.BackgroundMedianFilterDeviceTemplate, (13,)),
        (rfi_device.NoiseEstMADTDeviceTemplate, (32768,)),
        (rfi_device.NoiseEstMADDeviceTemplate, ()),
    ]
    shipped = {(r["fn"], r["version"], r["args"]) for r in table
               if r["platform"] == SHIPPED_DEVICE["platform"]
               and r["device_kind"] == SHIPPED_DEVICE["device_kind"]}
    for cls, args in canonical:
        fn = f"{cls.__name__}.autotune"
        assert cls.autotune_version in by_fn.get(fn, set()), (
            f"{fn}: shipped table has versions {sorted(by_fn.get(fn, set()))} "
            f"but the code requires autotune_version={cls.autotune_version} — "
            f"re-run scripts/tune_all.py on the card"
        )
        keys = tune._keys(cls.autotune, (None,) + args, {})
        assert (keys["fn"], cls.autotune_version, keys["args"]) in shipped, (
            f"{fn}: no shipped record at the production args {keys['args']} "
            f"(version {cls.autotune_version}) — the version matches but the "
            f"canonical instantiation would still run a live search"
        )
