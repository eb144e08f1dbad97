#!/usr/bin/env python
"""Per-stage device time of the 1-D flagger, from a profiler trace.

Flags a few dumps of the 4-pol MeerKAT shape (8064 rows × 32768 channels,
planar float32) under ``jax.profiler``, then attributes every kernel the
trace shows to the flagger stage whose ``jax.named_scope`` produced it
(``background_median_filter``, ``madnz``, ``threshold_sum``; anything
else is ``other``).  The attribution goes through the compiled HLO: each
trace event names its HLO instruction, and the instruction's ``op_name``
metadata carries the scope.  Bytes per launch are the sizes of the
instruction's operands plus its result, so a stage's bytes count what its
kernels read and write at least once each, not cache hits.

Prints one JSON line with, per stage, the device time per dump, the bytes
moved per dump, and bytes per visibility (the pipeline's floor is 9 B/vis:
8 read + 1 written).  ``--out DIR`` keeps the trace and the HLO text.

    python scripts/flagger_trace.py [--rows 8064] [--channels 32768] [--dumps 3]
"""

import argparse
import collections
import glob
import json
import pathlib
import re
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGES = ("background_median_filter", "madnz", "threshold_sum")
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
                "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
                "c128": 16}
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s+([\w\-]+)\((.*)$")
_ARRAY = re.compile(r"\b(pred|[suf]\d+|bf16|c64|c128)\[([\d,]*)\]")


def _bytes_of(type_text: str) -> int:
    total = 0
    for dtype, dims in _ARRAY.findall(type_text):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 4)
    return total


def _stage_of(text: str):
    op_name = re.search(r'op_name="([^"]*)"', text)
    if op_name:
        return next((s for s in STAGES if s in op_name.group(1)), None)
    return None


def hlo_instructions(hlo_text: str) -> dict:
    """HLO instruction name → (stage, bytes of operands + result).

    An instruction without a stage in its own metadata (a wrapped or
    fused computation) takes the first stage found in the computation it
    calls.
    """
    result_bytes, lines, comp_stage = {}, {}, {}
    computation = None
    for line in hlo_text.splitlines():
        header = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\(.*\))?.*\{\s*$", line)
        if header and "=" not in line.split("{", 1)[0]:
            computation = header.group(1)
            continue
        m = _INSTR.match(line)
        if m:
            name, type_text, _, rest = m.groups()
            result_bytes[name] = _bytes_of(type_text)
            lines[name] = rest
            stage = _stage_of(rest)
            if computation and stage and computation not in comp_stage:
                comp_stage[computation] = stage
    out = {}
    for name, rest in lines.items():  # definitions precede uses
        args = rest.split(")", 1)[0]
        operands = re.findall(r"%([\w.\-]+)", args)
        moved = result_bytes[name] + sum(result_bytes.get(o, 0) for o in operands)
        stage = _stage_of(rest)
        if stage is None:
            called = re.findall(r"(?:calls|to_apply|body|condition)=%([\w.\-]+)", rest)
            stage = next((comp_stage[c] for c in called if c in comp_stage), None)
        if stage is None:  # e.g. a split reduction: its producer's stage
            stage = next((out[o][0] for o in operands if o in out and out[o][0] != "other"),
                         "other")
        out[name] = (stage, moved)
    return out


def hlo_name(kernel: str, instructions: dict) -> str:
    """The HLO instruction a kernel was emitted for (``fusion_3`` → ``fusion.3``)."""
    if kernel in instructions:
        return kernel
    return re.sub(r"_(\d+)$", r".\1", kernel)


def kernel_events(xplane_path: str, module_prefix: str):
    """(op, duration_ns) of every kernel the trace shows.

    On a GPU the device plane's events are the kernels, named after their
    HLO instructions; only the traced program runs there.  Without a
    device plane (a CPU run) the host plane's per-op events of the module
    are used.
    """
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    events = []
    devices = [p for p in data.planes if p.name.startswith("/device:")]
    for plane in devices:
        for line in plane.lines:
            events.extend((ev.name, float(ev.duration_ns)) for ev in line.events)
    if devices:
        return events
    for plane in data.planes:
        if plane.name.startswith("/host:CPU"):
            for line in plane.lines:
                for ev in line.events:
                    stats = dict(ev.stats)
                    if "hlo_op" in stats and str(stats.get("hlo_module", "")).startswith(
                            module_prefix):
                        events.append((str(stats["hlo_op"]), float(ev.duration_ns)))
    return events


def stage_breakdown(events, instructions: dict, n_dumps: int, n_vis: int) -> dict:
    """Per-stage device seconds and bytes per dump, and bytes per visibility."""
    time_ns = collections.Counter()
    moved = collections.Counter()
    launches = collections.Counter()
    for op, dur in events:
        stage, nbytes = instructions.get(hlo_name(op, instructions), ("other", 0))
        time_ns[stage] += dur
        moved[stage] += nbytes
        launches[stage] += 1
    out = {}
    for stage in STAGES + ("other",):
        out[stage] = {
            "device_seconds_per_dump": time_ns[stage] * 1e-9 / n_dumps,
            "bytes_per_dump": moved[stage] / n_dumps,
            "bytes_per_vis": moved[stage] / n_dumps / n_vis,
            "launches_per_dump": launches[stage] / n_dumps,
        }
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=2016 * 4)
    parser.add_argument("--channels", type=int, default=32768)
    parser.add_argument("--dumps", type=int, default=3)
    parser.add_argument("--out", help="directory to keep the trace and HLO text in")
    args = parser.parse_args()

    import jax

    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.utils import backend

    backend.apply_platform_env()
    backend.enable_compile_cache()
    import chip_smoke

    dev = jax.devices()[0]
    vis = chip_smoke.make_dump(chip_smoke.SEED, args.channels, args.rows)
    fn = device.make_flagger_fn(width=13, n_sigma=11.0, threshold="sum")
    compiled = fn.lower(vis).compile()
    hlo_text = compiled.as_text()
    instructions = hlo_instructions(hlo_text)
    for _ in range(2):
        compiled(vis).block_until_ready()

    out_dir = pathlib.Path(args.out or tempfile.mkdtemp(prefix="flagger_trace_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flagger.hlo.txt").write_text(hlo_text)
    start = time.perf_counter()
    with jax.profiler.trace(str(out_dir / "trace")):
        for _ in range(args.dumps):
            compiled(vis).block_until_ready()
    wall = (time.perf_counter() - start) / args.dumps
    xplane = sorted(glob.glob(str(out_dir / "trace" / "**" / "*.xplane.pb"), recursive=True))[-1]
    events = kernel_events(xplane, "jit_block_fn")
    n_vis = args.rows * args.channels
    stages = stage_breakdown(events, instructions, args.dumps, n_vis)
    busy = sum(s["device_seconds_per_dump"] for s in stages.values())
    top = collections.Counter()
    for op, dur in events:
        top[(instructions.get(hlo_name(op, instructions), ("other", 0))[0], op)] += \
            dur / args.dumps
    for (stage, op), ns in top.most_common(15):
        print(f"{ns / 1e6:9.3f} ms  {stage:26s} {op}", file=sys.stderr)
    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()), "rows": args.rows, "channels": args.channels,
        "dumps": args.dumps, "traced_wall_seconds_per_dump": wall,
        "kernel_seconds_per_dump": busy, "stages": stages,
    }))


if __name__ == "__main__":
    main()
