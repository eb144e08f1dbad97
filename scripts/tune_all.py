#!/usr/bin/env python
"""Offline tuner: measure every autotuned template on this device.

Runs each template's measured autotune search (the reference equivalent is
the implicit first-use tuning + sqlite cache, tune.py:254-280) at the
standard benchmark configurations and merges the results into the in-repo
table ``katsdpsigproc_tpu/utils/tuning_table.json`` (or ``--out``).
Records are keyed by platform and device kind, and a failed search fails
the run.

Run on the card:  python scripts/tune_all.py [--out PATH]
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TABLE = ROOT / "katsdpsigproc_tpu" / "utils" / "tuning_table.json"
KEY_FIELDS = ("fn", "version", "platform", "device_kind", "args")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=str(TABLE),
                        help="table to merge the new records into (default: the shipped one)")
    args = parser.parse_args()

    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()

    from katsdpsigproc_tpu.models.rfi import device as rfi_device
    from katsdpsigproc_tpu.ops import percentile
    from katsdpsigproc_tpu.utils import tune

    ctx = backend.create_some_context()
    print(f"tuning for {ctx.device} ({ctx.device_kind})", file=sys.stderr)

    # Force real searches and collect what they would cache.  (Plain
    # instantiation would hit the shipped table and never re-measure.)
    new = []

    def forcing_impl(test, fn, *fn_args, **kwargs):
        cls = fn_args[0] if fn_args else None
        keys = tune._keys(fn, fn_args, kwargs)
        keys["version"] = getattr(cls, "autotune_version", 0)
        keys.update(tune._device_columns())
        result = fn(*fn_args, **kwargs)
        new.append({**keys, "result": dict(result)})
        return result

    tune.autotuner_impl = forcing_impl
    choices = {
        "percentile 5000": percentile.Percentile5Template(ctx, 5000, True).engine,
        "background median": rfi_device.BackgroundMedianFilterDeviceTemplate(ctx, 13).engine,
        "madnz transposed": rfi_device.NoiseEstMADTDeviceTemplate(ctx).radix_bits,
        "madnz straight": rfi_device.NoiseEstMADDeviceTemplate(ctx).radix_bits,
    }
    for label, choice in choices.items():
        print(f"{label}: {choice}", file=sys.stderr)

    out = pathlib.Path(args.out)
    old = json.loads(TABLE.read_text()) if TABLE.exists() else []
    merged = {tuple(r.get(k) for k in KEY_FIELDS): r for r in old}
    merged.update({tuple(r.get(k) for k in KEY_FIELDS): r for r in new})
    records = sorted(merged.values(), key=lambda r: (r["fn"], r["args"], r["platform"],
                                                     r["device_kind"]))
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile("w", dir=out.parent, delete=False) as f:
        json.dump(records, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(f.name, out)
    print(f"wrote {len(records)} records to {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
