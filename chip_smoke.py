#!/usr/bin/env python
"""Run the RFI flagger's main path on one NVIDIA GPU and check every result.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the channel-sharded flagger on four
                                       # cards against one card, and nothing else

Everything runs in one process, so one JAX process holds the card.  The
phases, in order:

1. device — the card's name and power limit (``nvidia-smi``), JAX's device
   kind and count;
2. compile — the full-width flagger, ``make_flagger_fn(width=13,
   n_sigma=11.0, threshold="sum")``, on the 4-pol MeerKAT dump: 2016
   baselines × 4 pols = 8064 rows × 32768 channels of planar float32
   (2.11 GB in, 264 MB of uint8 flags out), with its compile time and
   ``memory_analysis()``;
3. flagger parity — the dump, generated on the card from a seed with
   planted spikes, is flagged; at least 64 complete baselines (all 32768
   channels, the first and the last among them) must match the numpy host
   oracle bit for bit, and the whole dump's flags must be identical between
   the slab-blocked (``baseline_block=288``) and the unblocked call;
4. the other device paths at the benchmark's shapes, each against its plain
   reference: the 2-D flagger (``tests/rfi/twodflag_oracle.py``),
   percentile5's tuned, rank and sort engines (``np.percentile``),
   maskedsum (a float64 sum), the complex64 transpose (numpy) and the FFT
   spectral flag (``np.fft``);
5. steady timing — the full-width flagger's median and spread over timed
   ``block_until_ready`` windows.

Every tuned template must resolve from the shipped tuning table: a miss
fails the run instead of starting a live search.  The script refuses to
run unless JAX's first device is a GPU, and its last line on stdout is one
JSON object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.
The check functions take their shapes as arguments, so the CPU tests run
the same checks at tiny shapes.
"""

import argparse
import contextlib
import functools
import json
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

#: The 4-pol MeerKAT dump: 2016 baselines × 4 pols, 32768 channels.
CHANNELS = 32768
ROWS = 2016 * 4
WIDTH = 13
N_SIGMA = 11.0
SLAB = 288
PARITY_BASELINES = 64
SEED = 1


class SmokeFailure(RuntimeError):
    """A phase produced a wrong result."""


def require(cond, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def log(*args) -> None:
    print(*args, flush=True)


def gpu_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    require(out, "nvidia-smi reported no GPU")
    return out


@functools.partial(jax.jit, static_argnums=(1, 2))
def make_dump(seed, channels: int, rows: int):
    """Planar (channels, rows, 2) float32 visibilities made on the device.

    Complex Gaussian noise with one spike in 64 samples (real part raised
    by 50..70), the same recipe the benchmark uses; only the seed travels
    to the device.
    """
    import jax.numpy as jnp

    k_noise, k_where, k_amp = jax.random.split(jax.random.PRNGKey(seed), 3)
    vis = jax.random.normal(k_noise, (channels, rows, 2), jnp.float32)
    spikes = jax.random.uniform(k_where, (channels, rows)) < 1.0 / 64.0
    amp = jax.random.uniform(k_amp, (channels, rows)) * 20.0 + 50.0
    return vis.at[..., 0].add(jnp.where(spikes, amp, 0.0))


def parity_columns(rows: int, n: int = PARITY_BASELINES) -> np.ndarray:
    """`n` baseline columns spread evenly over the dump, first and last included."""
    return np.unique(np.linspace(0, rows - 1, min(n, rows)).round().astype(np.int64))


def host_flagger(width: int, n_sigma: float):
    from katsdpsigproc_tpu.models.rfi import host

    return host.FlaggerHost(
        host.BackgroundMedianFilterHost(width),
        host.NoiseEstMADHost(),
        host.ThresholdSumHost(n_sigma),
    )


def check_flagger_vs_host(vis, flags, columns, width: int = WIDTH,
                          n_sigma: float = N_SIGMA) -> int:
    """Flag `columns` of the planar dump with the host oracle; flags must match.

    Baselines are independent, so the oracle sees only the chosen complete
    columns.  Returns the number of flags compared.
    """
    sub = np.asarray(vis[:, columns, :])
    expected = host_flagger(width, n_sigma)(sub[..., 0] + 1j * sub[..., 1])
    got = np.asarray(flags[:, columns])
    mismatches = int((got != expected).sum())
    require(mismatches == 0,
            f"flagger: {mismatches} of {expected.size} flags differ from the host oracle")
    require(expected.any(), "flagger: the planted spikes produced no flags")
    return int(expected.size)


def check_flags_equal(a, b, what: str) -> int:
    """Whole-array flag comparison, done on the device."""
    import jax.numpy as jnp

    require(a.shape == b.shape, f"{what}: shapes {a.shape} and {b.shape} differ")
    mismatches = int(jnp.sum(a != b))
    require(mismatches == 0, f"{what}: {mismatches} of {a.size} flags differ")
    return int(a.size)


def _synthetic_cube(rs, shape):
    """Amplitudes of complex noise with 2% planted spikes, (time, freq, bl)."""
    data = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
    spikes = rs.random_sample(shape) < 0.02
    return np.abs(data + spikes * (30.0 + 5.0 * rs.random_sample(shape))).astype(np.float32)


def check_twodflag(shape, seed: int = SEED, **params) -> int:
    """2-D SumThreshold flagger against the independent numpy oracle: exact."""
    from katsdpsigproc_tpu.models.rfi import twodflag
    from tests.rfi import twodflag_oracle

    rs = np.random.RandomState(seed)
    data = _synthetic_cube(rs, shape)
    flags = np.zeros(shape, bool)
    got = twodflag.SumThresholdFlagger(**params).get_flags(data, flags)
    expected = twodflag_oracle.get_flags(data, flags, **params)
    mismatches = int((got != expected).sum())
    require(mismatches == 0,
            f"twodflag {shape}: {mismatches} of {expected.size} flags differ from the oracle")
    require(expected.any(), f"twodflag {shape}: nothing flagged")
    return int(expected.size)


def check_percentile(rows: int, cols: int, engine: str, seed: int = SEED) -> None:
    """percentile5 against ``np.percentile(..., method="lower")``: exact."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import percentile

    data = np.random.RandomState(seed).uniform(0.0, 1.0, (rows, cols)).astype(np.float32)
    got = np.asarray(percentile.percentile5(jnp.asarray(data), engine=engine))
    expected = np.stack([
        data.min(axis=1), data.max(axis=1),
        *(np.percentile(data, q, axis=1, method="lower") for q in (25, 75, 50)),
    ]).astype(np.float32)
    require(np.array_equal(got, expected),
            f"percentile5[{engine}] {rows}x{cols}: "
            f"{int((got != expected).sum())} of {expected.size} values differ")


#: maskedsum's bound on |device − float64 sum| / sum(|mask|·|src|) per column.
#: The reference sums float32 products in float32; XLA sums them in a tree,
#: whose rounding error grows as log2(rows)·eps ≈ 7e-7 of that scale at 4096
#: rows, so 1e-5 leaves an order of magnitude.  The scale is the sum of the
#: terms' magnitudes because a complex column's sum can cancel to near zero.
#: The dot asks for Precision.HIGHEST: a TF32 product alone errs by up to
#: 5e-4 of each term.
MASKEDSUM_RTOL = 1e-5


def check_maskedsum(rows: int, cols: int, use_amplitudes: bool, seed: int = SEED) -> float:
    """maskedsum (complex64 in) against a float64 numpy sum; returns the worst error."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import maskedsum

    rs = np.random.RandomState(seed)
    src = (rs.standard_normal((rows, cols)) + 1j * rs.standard_normal((rows, cols))
           ).astype(np.complex64)
    mask = rs.random_sample(rows).astype(np.float32)
    op = maskedsum.MaskedSumTemplate(None, use_amplitudes).instantiate(None, (rows, cols))
    got = np.asarray(op(src=jnp.asarray(src), mask=jnp.asarray(mask))["dest"])
    src64 = src.astype(np.complex128)
    terms = np.abs(src64) if use_amplitudes else src64
    expected = (mask.astype(np.float64)[:, None] * terms).sum(axis=0)
    scale = (mask.astype(np.float64)[:, None] * np.abs(src64)).sum(axis=0)
    err = float(np.max(np.abs(got - expected) / scale))
    require(err <= MASKEDSUM_RTOL,
            f"maskedsum {rows}x{cols} amplitudes={use_amplitudes}: relative error "
            f"{err:.3g} > {MASKEDSUM_RTOL}")
    return err


def check_transpose(rows: int, cols: int, seed: int = SEED) -> None:
    """complex64 corner turn through the Operation API against numpy: exact."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.ops import transpose

    rs = np.random.RandomState(seed)
    src = (rs.standard_normal((rows, cols)) + 1j * rs.standard_normal((rows, cols))
           ).astype(np.complex64)
    op = transpose.TransposeTemplate(None, np.complex64).instantiate(None, (rows, cols))
    got = np.asarray(op(src=jnp.asarray(src))["dest"])
    require(np.array_equal(got, src.T), f"transpose {rows}x{cols}: result differs from numpy")


#: Spectral-flag bounds.  A float32 FFT of n points errs by ~eps·log2(n) of
#: the row's norm, which moves a bin's amplitude by ~1e-6 of the threshold
#: at these sizes: only a bin within SPECTRAL_BAND of its threshold may
#: flag differently from the float64 reference.  The cleaned series may
#: differ from np.fft by SPECTRAL_RTOL of the row's largest sample.
SPECTRAL_BAND = 1e-4
SPECTRAL_RTOL = 1e-4


def spectral_data(rows: int, n: int, seed: int = SEED) -> np.ndarray:
    """Noise with strong sinusoids planted in every 7th row."""
    data = np.random.RandomState(seed).standard_normal((rows, n)).astype(np.float32)
    t = np.arange(n)
    for i in range(0, rows, 7):
        data[i] += 20.0 * np.sin(2 * np.pi * (0.1 + 0.3 * i / rows) * t).astype(np.float32)
    return data


def check_spectral_flag(rows: int, n: int, n_sigma: float = 5.0, seed: int = SEED) -> int:
    """FFT spectral flag against np.fft in float64; returns flags compared."""
    import jax.numpy as jnp

    from katsdpsigproc_tpu.models.rfi import MAD_NORMAL, device

    data = spectral_data(rows, n, seed)
    flags, cleaned = device.spectral_flag(jnp.asarray(data), n_sigma)
    flags = np.asarray(flags).astype(bool)
    spectrum = np.fft.rfft(data.astype(np.float64), axis=-1)
    amp = np.abs(spectrum)
    nonzero = np.where(amp > 0, amp, np.nan)
    threshold = n_sigma * MAD_NORMAL * np.nanmedian(nonzero, axis=-1, keepdims=True)
    expected = amp > threshold
    differ = flags != expected
    near = np.abs(amp - threshold) <= SPECTRAL_BAND * threshold
    require(not (differ & ~near).any(),
            f"spectral flag {rows}x{n}: {int((differ & ~near).sum())} flags differ "
            f"from np.fft away from the threshold")
    require(flags[::7].any(axis=-1).all(), "spectral flag: planted sinusoid not flagged")
    ref = np.fft.irfft(np.where(flags, 0.0, spectrum), n=n, axis=-1)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    err = float(np.max(np.abs(np.asarray(cleaned) - ref) / scale))
    require(err <= SPECTRAL_RTOL,
            f"spectral flag {rows}x{n}: cleaned series error {err:.3g} > {SPECTRAL_RTOL}")
    return int(flags.size)


@contextlib.contextmanager
def strict_tuning():
    """Resolve every tuned template from the tables; a miss raises."""
    from katsdpsigproc_tpu.utils import tune

    def table_only(test, fn, *args, **kwargs):
        cls = args[0] if args else None
        keys = tune._keys(fn, args, kwargs)
        keys["version"] = getattr(cls, "autotune_version", 0)
        keys.update(tune._device_columns())
        found = tune._fetch(keys)
        if found is None:
            raise SmokeFailure(f"no tuning record for {keys}: a live search would run")
        return found

    saved = tune.autotuner_impl
    tune.autotuner_impl = table_only
    try:
        yield
    finally:
        tune.autotuner_impl = saved


def tuned_choices(context) -> dict:
    """Instantiate every autotuned template strictly; return its choices."""
    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.ops import percentile

    with strict_tuning():
        return {
            "percentile5_engine": percentile.Percentile5Template(context, 5000, True).engine,
            "background_engine":
                device.BackgroundMedianFilterDeviceTemplate(context, WIDTH).engine,
            "madnz_t_radix_bits": device.NoiseEstMADTDeviceTemplate(context).radix_bits,
            "madnz_radix_bits": device.NoiseEstMADDeviceTemplate(context).radix_bits,
        }


def spread(samples) -> str:
    q1, med, q3 = np.percentile(samples, [25, 50, 75])
    return (f"median {med * 1e3:.3f} ms, IQR {q1 * 1e3:.3f}..{q3 * 1e3:.3f} ms, "
            f"min {np.min(samples) * 1e3:.3f} ms, max {np.max(samples) * 1e3:.3f} ms, "
            f"n={len(samples)}")


def one_card(card: str) -> None:
    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.utils import backend, profiling

    dev = jax.devices()[0]
    tuned = tuned_choices(backend.DeviceContext(dev))
    log(f"[tuning] every template resolved from the shipped table: {tuned}")

    # ---- 2. compile ------------------------------------------------------
    vis = make_dump(SEED, CHANNELS, ROWS)
    vis.block_until_ready()
    log(f"[compile] dump {vis.shape} {vis.dtype}, {vis.nbytes / 1e9:.3f} GB on {dev}")
    flagger = device.make_flagger_fn(width=WIDTH, n_sigma=N_SIGMA, threshold="sum")
    blocked = device.make_flagger_fn(width=WIDTH, n_sigma=N_SIGMA, threshold="sum",
                                     baseline_block=SLAB)
    compiled = {}
    for name, fn in (("unblocked", flagger), ("blocked", blocked)):
        start = time.perf_counter()
        compiled[name] = fn.lower(vis).compile()
        log(f"[compile] {name}: {time.perf_counter() - start:.1f} s; "
            f"{compiled[name].memory_analysis()}")
    flagger, blocked = compiled["unblocked"], compiled["blocked"]

    # ---- 3. flagger parity ----------------------------------------------
    flags = flagger(vis)
    flags.block_until_ready()
    log(f"[parity] flags {flags.shape} {flags.dtype}; peak_bytes_in_use "
        f"{dev.memory_stats().get('peak_bytes_in_use')}; flagged fraction "
        f"{float(flags.mean()):.5f}")
    columns = parity_columns(ROWS)
    require(columns.size >= PARITY_BASELINES and columns[0] == 0 and columns[-1] == ROWS - 1,
            "parity baselines must include the first and the last")
    n = check_flagger_vs_host(vis, flags, columns)
    log(f"[parity] {columns.size} complete baselines x {CHANNELS} channels: "
        f"{n} flags bit-identical to the host oracle")
    n = check_flags_equal(blocked(vis), flags, "blocked vs unblocked")
    log(f"[parity] blocked (baseline_block={SLAB}) vs unblocked: all {n} flags identical")

    # ---- 4. the other device paths ----------------------------------------
    n = check_twodflag((3000, 1024, 1))
    log(f"[twodflag] 3000x1024x1: {n} flags identical to the numpy oracle")
    for rows, cols in ((64, 4096), (4000, 5000)):
        for engine in ("rank", "sort"):
            check_percentile(rows, cols, engine)
        log(f"[percentile5] {rows}x{cols}: rank and sort engines (tuned: "
            f"{tuned['percentile5_engine']}) equal np.percentile(method='lower')")
    for amps in (False, True):
        err = check_maskedsum(4096, 64, amps)
        log(f"[maskedsum] 4096x64 amplitudes={amps}: worst relative error {err:.3g} "
            f"<= {MASKEDSUM_RTOL}")
    check_transpose(8192, 2016)
    log("[transpose] complex64 8192x2016 equals numpy")
    n = check_spectral_flag(256, 32768)
    log(f"[fft] spectral flag 256x32768: {n} bins agree with np.fft")

    # ---- 5. steady timing ------------------------------------------------
    samples = profiling.time_samples(lambda: flagger(vis), iters=20, warmup=3)
    log(f"[timing] flagger {ROWS}x{CHANNELS} on {card}: {spread(samples)}; "
        f"{ROWS * CHANNELS / np.median(samples) / 1e9:.3f} Gvis/s")


def four_cards(card: str, channels: int = CHANNELS, rows: int = ROWS) -> int:
    """The channel-sharded flagger on a 4-device channel mesh vs one card.

    Returns the number of flags compared.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from katsdpsigproc_tpu.models.rfi import device
    from katsdpsigproc_tpu.parallel import flagger as pflagger, mesh as pmesh
    from katsdpsigproc_tpu.utils import profiling

    devices = jax.devices()
    require(len(devices) >= 4, f"--four-cards needs 4 devices, JAX sees {len(devices)}")
    mesh = pmesh.make_mesh((1, 4), (pmesh.BASELINE_AXIS, pmesh.CHANNEL_AXIS),
                           devices=devices[:4])
    vis = jax.device_put(make_dump(SEED, channels, rows), devices[0])
    vis_sharded = jax.device_put(
        vis, NamedSharding(mesh, P(pmesh.CHANNEL_AXIS, pmesh.BASELINE_AXIS, None)))
    sharded = pflagger.make_sharded_flagger(mesh, width=WIDTH, n_sigma=N_SIGMA,
                                            threshold="sum")
    flags_4 = sharded(vis_sharded)
    flags_4.block_until_ready()
    for name, arr in (("vis", vis_sharded), ("flags", flags_4)):
        shards = arr.addressable_shards
        placed = {s.device for s in shards}
        require(len(placed) == 4, f"{name}: shards on {len(placed)} devices, want 4")
        log(f"[shards] {name}: " + ", ".join(f"{s.device}: {s.data.shape}" for s in shards))
    flagger = device.make_flagger_fn(width=WIDTH, n_sigma=N_SIGMA, threshold="sum")
    flags_1 = flagger(vis)
    n = check_flags_equal(jax.device_put(flags_4, devices[0]), flags_1,
                          "4-card channel-sharded vs 1-card")
    log(f"[four-cards] channel-sharded flags on 4 devices: all {n} identical to one card")
    t4 = profiling.time_samples(lambda: sharded(vis_sharded), iters=10, warmup=2)
    t1 = profiling.time_samples(lambda: flagger(vis), iters=10, warmup=2)
    log(f"[timing] 4-card channel-sharded on {card}: {spread(t4)}")
    log(f"[timing] 1-card control on {card}: {spread(t1)}")
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the channel-sharded flagger on four cards "
                             "against the one-card flagger")
    args = parser.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 2
    from katsdpsigproc_tpu.utils import backend

    log(f"[cache] compile cache: {backend.enable_compile_cache()}")
    cards = gpu_identity()
    log(cards)
    card = cards.splitlines()[0]
    log(f"[device] {dev.platform} / {dev.device_kind} x {len(jax.devices())} "
        f"(jax {jax.__version__})")
    if args.four_cards:
        four_cards(card)
    else:
        one_card(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
