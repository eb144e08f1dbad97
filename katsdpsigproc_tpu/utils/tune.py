"""Offline tuning with a static, shippable tuning table.

The reference autotunes kernels at runtime with a grid search and caches
results in a per-user sqlite database (reference: src/katsdpsigproc/tune.py).
Accelerator models are few and XLA specializes at trace time, so this
framework replaces that machinery with a **static JSON tuning table** shipped in the
repo (``tuning_table.json``), with the same developer contract:

* ``@autotuner(test={...})`` decorates a class's ``autotune`` classmethod
  (reference tune.py:283-313).  Calls consult the shipped table and a user
  cache; a miss runs the real (measured) search and saves to the user cache.
* ``stub_autotuner`` / ``force_autotuner`` reproduce the reference's test
  hooks (tune.py:316-334): unit tests patch :data:`autotuner_impl` to the
  stub so no benchmarking happens, and ``force_autotune`` runs the search
  end-to-end.
* :func:`autotune` is the grid-search engine (reference tune.py:354-448):
  per-config exceptions are skips; only if *every* config fails is the last
  exception re-raised.
* :func:`make_measure` builds a timing callable (reference tune.py:337-351)
  using wall-clock windows around ``block_until_ready`` — the analogue of
  the reference's device-event timing brackets.

Environment variables (mirroring ``KATSDPSIGPROC_TUNE_MATCH`` /
``KATSDPSIGPROC_TUNE_DB``, reference tune.py:75-81, 235-241):

``KATSDPSIGPROC_TPU_TUNE_DB``
    Path of the user-cache JSON file.
``KATSDPSIGPROC_TPU_TUNE_MATCH``
    ``exact`` or ``nearest`` (default). ``nearest`` ignores the
    device_kind column when no exact record matches; the platform always
    has to match.
"""

import enum
import functools
import inspect
import itertools
import json
import logging
import os
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

_logger = logging.getLogger(__name__)

#: Shipped (in-repo) tuning table path.
_TABLE_PATH = os.path.join(os.path.dirname(__file__), "tuning_table.json")


def _user_db_path() -> str:
    env = os.environ.get("KATSDPSIGPROC_TPU_TUNE_DB")
    if env is not None:
        return env
    cache_home = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(cache_home, "katsdpsigproc_tpu", "tuning.json")


def _load_records(path: str) -> List[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return []


def _save_record(record: dict) -> None:
    path = _user_db_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    records = _load_records(path)
    # Replace any record with the same primary key (ON CONFLICT REPLACE,
    # reference tune.py:202-211).
    key_fields = ("fn", "version", "platform", "device_kind", "args")
    records = [r for r in records if any(r.get(k) != record[k] for k in key_fields)]
    records.append(record)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(records, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _device_columns() -> Dict[str, str]:
    from . import backend

    platform, kind = backend.device_kind_key()
    return {"platform": platform, "device_kind": kind}


def adapt_value(value: Any) -> Any:
    """Coerce `value` to a stable, encodable lookup-key form.

    Reference tune.py:93-104 (sqlite key adaptation): types and dtypes
    become their ``repr``, enum members their name; everything else passes
    through (and falls back to ``repr`` at encoding time if it is not
    JSON-encodable).
    """
    if isinstance(value, type) or isinstance(value, np.dtype):
        return repr(value)
    if isinstance(value, enum.Enum):
        return value.name
    return value


def _keys(fn: Callable, args: tuple, kwargs: dict) -> Dict[str, Any]:
    """Build the lookup key from the function's bound signature.

    The reference binds the signature and stores each argument as an
    ``arg_*`` column (tune.py:107-128); here the bound arguments are
    JSON-encoded into a single ``args`` string.
    """
    sig = inspect.signature(fn)
    bound = sig.bind(*args, **kwargs)
    bound.apply_defaults()
    plain = {}
    for name, value in bound.arguments.items():
        if name in ("cls", "self", "context"):
            continue
        value = adapt_value(value)
        try:
            json.dumps(value)
            plain[name] = value
        except TypeError:
            plain[name] = repr(value)
    return {
        "fn": getattr(fn, "__qualname__", fn.__name__),
        "args": json.dumps(plain, sort_keys=True),
    }


def _fetch(keys: Dict[str, Any]) -> Optional[Mapping[str, Any]]:
    """Look up `keys` in the shipped table then the user cache.

    With ``nearest`` matching, drop the device_kind constraint (reference
    tune.py:151-199 drops driver → platform → name).  A record is never
    inherited across platforms: its knobs name kernels and engines that
    another backend may not compile.
    """
    match = os.environ.get("KATSDPSIGPROC_TPU_TUNE_MATCH", "nearest")
    records = _load_records(_user_db_path()) + _load_records(_TABLE_PATH)
    drop_orders: List[tuple] = [()]
    if match == "nearest":
        drop_orders.append(("device_kind",))
    for dropped in drop_orders:
        want = {k: v for k, v in keys.items() if k not in dropped}
        for rec in records:
            if all(rec.get(k) == v for k, v in want.items()):
                if dropped:
                    # Inheriting from another model of the same platform is
                    # better than a live search, but the choice was
                    # measured on another device — say so.
                    _logger.warning(
                        "tuning record for %s inherited from %s/%s (this device: "
                        "%s/%s) — re-run scripts/tune_all.py on this hardware "
                        "for tuned block shapes",
                        keys.get("fn"), rec.get("platform"), rec.get("device_kind"),
                        keys.get("platform"), keys.get("device_kind"))
                return rec["result"]
    return None


def autotuner_impl(test: Mapping[str, Any], fn: Callable, *args, **kwargs) -> Mapping[str, Any]:
    """Table lookup with measured-search fallback (reference tune.py:254-280).

    Unit tests monkeypatch this module attribute to :func:`stub_autotuner`
    (see :mod:`katsdpsigproc_tpu.pytest_plugin`).  Setting
    ``KATSDPSIGPROC_TPU_TUNE_STUB=1`` applies the same stubbing across
    process boundaries (subprocess smoke tests of the CLI harnesses, where
    monkeypatching cannot reach): a table miss returns the decorator's
    ``test`` configuration instead of running a measured search.
    """
    cls = args[0] if args else None
    version = getattr(cls, "autotune_version", 0)
    keys = _keys(fn, args, kwargs)
    keys["version"] = version
    keys.update(_device_columns())
    cached = _fetch(keys)
    if cached is not None:
        return cached
    if os.environ.get("KATSDPSIGPROC_TPU_TUNE_STUB"):
        return test
    _logger.info("Autotuning %s with args %s", keys["fn"], keys["args"])
    result = fn(*args, **kwargs)
    _save_record({**keys, "result": dict(result)})
    return result


def stub_autotuner(test: Mapping[str, Any], fn: Callable, *args, **kwargs) -> Mapping[str, Any]:
    """Return the decorator's ``test`` configuration without any measurement.

    Reference: tune.py:328-334.
    """
    return test


def force_autotuner(test: Mapping[str, Any], fn: Callable, *args, **kwargs) -> Mapping[str, Any]:
    """Run the real tuning search, bypassing the table (reference tune.py:316-326)."""
    return fn(*args, **kwargs)


def autotuner(test: Mapping[str, Any]) -> Callable:
    """Decorator for ``autotune`` classmethods (reference tune.py:283-313).

    The decorated function performs the *real* measured search; calls are
    routed through :data:`autotuner_impl` so that the static table, the
    stub (unit tests), or the forced search can be selected externally.
    """

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # Late-bound module attribute so monkeypatching works.
            import katsdpsigproc_tpu.utils.tune as _tune

            return _tune.autotuner_impl(test, fn, *args, **kwargs)

        wrapper.autotune_test = test  # type: ignore[attr-defined]
        return wrapper

    return decorator


def make_measure(fn: Callable[..., Any], *args, warmup: int = 1) -> Callable[[int], float]:
    """Build a measurement function for :func:`autotune`.

    ``measure(iters)`` returns the median seconds of ``fn(*args)`` over
    `iters` calls, each waited for with ``block_until_ready``, after
    `warmup` untimed calls (:func:`..profiling.time_fn`; reference
    tune.py:337-351).
    """
    from .profiling import time_fn

    def measure(iters: int) -> float:
        return time_fn(lambda: fn(*args), iters=iters, warmup=warmup)

    return measure


def autotune(generate: Callable[..., Callable[[int], float]], time_limit: float = 0.1, **kwargs):
    """Grid-search tuner (reference tune.py:354-448).

    Parameters
    ----------
    generate
        Called with one keyword per parameter; returns a measurement
        function (see :func:`make_measure`) or raises to skip the config.
    time_limit
        Approximate measurement budget per configuration, seconds.
    kwargs
        Lists of candidate values; the search space is their product.

    Returns
    -------
    The best-scoring configuration dict.

    Raises
    ------
    Exception
        The last per-configuration exception, if *every* configuration
        failed (reference tune.py:436-447).
    """
    best = None
    best_score = None
    last_exc: Optional[BaseException] = None
    names = list(kwargs.keys())
    for values in itertools.product(*kwargs.values()):
        config = dict(zip(names, values))
        try:
            measure = generate(**config)
            elapsed = measure(1)
            iters = max(3, int(time_limit / max(elapsed, 1e-9)))
            iters = min(iters, 100)
            score = measure(iters)
        except Exception as exc:  # noqa: BLE001 — skip failing configs
            _logger.debug("Skipping config %s: %s", config, exc)
            last_exc = exc
            continue
        _logger.debug("Config %s scored %.6fs", config, score)
        if best_score is None or score < best_score:
            best, best_score = config, score
    if best is None:
        assert last_exc is not None
        raise last_exc
    return best
