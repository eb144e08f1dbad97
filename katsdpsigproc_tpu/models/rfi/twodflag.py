"""2-D (time–frequency) SumThreshold flagger.

Re-design of the reference's production CPU flagger (reference:
src/katsdpsigproc/rfi/twodflag.py — numba-JIT kernels dispatched over
thread/process pools per baseline-chunk, rfi/twodflag.py:1029-1118) as pure
JAX, vmapped over baselines.  The algorithm (reference
twodflag.py:894-913) is preserved step for step:

1. average the data in frequency by ``average_freq``;
2. flag a time-median spectrum to catch faintly contaminated channels;
3. derive a smooth 2-D background per frequency chunk (iterative masked
   Gaussian via repeated box filters, Getreuer 2013 — reference
   twodflag.py:254-463);
4. SumThreshold the background-subtracted data in time and frequency with
   per-chunk noise estimates;
5. extend flags in time/frequency and fully flag over-flagged rows/columns.

Design deltas:

* numba serial loops → vectorized array ops (masked medians via the exact
  bitwise rank search; NaN interpolation via log-shift fills; box
  filters via ``lax.reduce_window`` window sums, which keep summation local
  instead of the reference's long double-precision rolling sums,
  twodflag.py:284-307);
* per-baseline host parallelism (thread/process pools) → ``jax.vmap`` over
  the baseline axis with optional sequential chunking to bound memory;
  ``pool`` arguments are accepted for API compatibility and ignored.
"""

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import MAD_NORMAL
from ...ops import rank as rank_ops

_MAX_BOX_RADIUS_PASSES = 4


def _asbool(data):
    """View/convert flag data to bool (reference twodflag.py:52-64)."""
    return data if data.dtype == jnp.bool_ else data != 0


def _masked_median_axis0(data, valid, *, empty_value):
    """Median along axis 0 of the entries where `valid`, else `empty_value`.

    Averages the two central values for even counts (np.median semantics,
    as used throughout the reference's masked medians,
    twodflag.py:119-196).  Returns an array of shape ``data.shape[1:]``.

    All twodflag medians run on non-negative float32 (amplitudes or
    absolute residuals), so the exact bitwise rank search applies
    (reference rank.mako:186-231): 31 vectorized compare-count rounds
    instead of an axis sort — no sorted intermediate, fuses with the
    surrounding graph.  Masked entries become NaN ("absent" in the rank
    machinery); ``result + prev) * 0.5`` reproduces np.median's central
    averaging bit for bit.
    """
    if data.shape[0] == 0:
        # Empty population (e.g. a zero-length frequency chunk when
        # freq_chunks > channels): every output is the empty value.
        return jnp.full(data.shape[1:], empty_value, data.dtype)
    vals = jnp.where(valid, data, jnp.nan)
    # Search along the last axis, batched over the rest.
    vals_t = jnp.moveaxis(vals, 0, -1)
    n = jnp.sum(valid, axis=0, dtype=jnp.int32)
    med = rank_ops.find_rank_float(vals_t, n // 2, (n & 1) == 0, unroll=False, radix_bits=4)
    return jnp.where(n > 0, med, jnp.asarray(empty_value, data.dtype))


def _average_freq(in_data, in_flags, factor: int):
    """Amplitude, NaN-flagging, zeroing, frequency averaging, transpose.

    Reference twodflag.py:67-116.  (time, freq, bl) → baseline-major
    (bl, time, ceil(freq/factor)) float32 data plus bool flags marking
    fully-flagged bins.
    """
    amp = jnp.abs(in_data).astype(jnp.float32)
    good = (~_asbool(in_flags)) & ~jnp.isnan(amp)
    vals = jnp.where(good, amp, 0.0)
    n_time, n_freq, n_bl = amp.shape
    a_freq = -(-n_freq // factor)
    pad = a_freq * factor - n_freq
    if pad:
        vals = jnp.pad(vals, ((0, 0), (0, pad), (0, 0)))
        good = jnp.pad(good, ((0, 0), (0, pad), (0, 0)))
    sums = vals.reshape(n_time, a_freq, factor, n_bl).sum(axis=2)
    counts = good.reshape(n_time, a_freq, factor, n_bl).sum(axis=2, dtype=jnp.int32)
    avg = jnp.where(counts > 0, sums / counts, 0.0).astype(jnp.float32)
    flags = counts == 0
    return jnp.moveaxis(avg, -1, 0), jnp.moveaxis(flags, -1, 0)


def _time_median(data, flags):
    """Per-channel median of unflagged values over time (reference
    twodflag.py:119-158): all-flagged channels give 0 and a flag."""
    med = _masked_median_axis0(data, ~flags, empty_value=0.0)
    out_flags = jnp.all(flags, axis=0)
    return med[None], out_flags[None]


def _median_abs(data, flags):
    """Median of |data| over non-flagged entries; NaN if none
    (reference twodflag.py:161-173)."""
    flat = jnp.abs(data).reshape(-1, 1)
    valid = (~flags).reshape(-1, 1)
    return _masked_median_axis0(flat, valid, empty_value=jnp.nan)[0]


def _median_abs_axis0(data, flags):
    """Median of |data| along axis 0 over non-flagged entries; NaN if none
    (reference twodflag.py:176-196). Keeps axis 0 as size 1."""
    return _masked_median_axis0(jnp.abs(data), ~flags, empty_value=jnp.nan)[None]


def _fill_hillis(data, idx0, *, reverse: bool):
    """Nearest-non-NaN fill along axis -2 by Hillis-Steele log shifts.

    Returns (values, indices): per position, the value and the index of the
    nearest non-NaN element at-or-before (at-or-after when `reverse`) along
    axis -2; NaN / -1 where none exists.  (value, index) propagate under a
    single ``isnan`` predicate, so the -1/NaN invariant is maintained by the
    shift padding alone.

    """
    n = data.shape[-2]
    v = data
    iv = jnp.where(jnp.isnan(data), jnp.int32(-1), idx0)
    d = 1
    while d < n:
        padv = jnp.full(v.shape[:-2] + (d,) + v.shape[-1:], jnp.nan, v.dtype)
        padi = jnp.full(iv.shape[:-2] + (d,) + iv.shape[-1:], -1, iv.dtype)
        if reverse:
            sv = jnp.concatenate([v[..., d:, :], padv], -2)
            si = jnp.concatenate([iv[..., d:, :], padi], -2)
        else:
            sv = jnp.concatenate([padv, v[..., :-d, :]], -2)
            si = jnp.concatenate([padi, iv[..., :-d, :]], -2)
        take = jnp.isnan(v)
        v = jnp.where(take, sv, v)
        iv = jnp.where(take, si, iv)
        d *= 2
    return v, iv


def _linearly_interpolate_nans1d(data):
    """Replace NaNs by linear interpolation along the last axis.

    Extrapolation repeats the first/last valid value; all-NaN rows become 0
    (reference twodflag.py:199-237).  Works on (..., N).  The interpolation
    axis is moved to axis -2 for the fills (see :func:`_fill_hillis`).
    """
    if data.ndim == 1:
        return _linearly_interpolate_nans1d(data[None])[0]
    moved = jnp.moveaxis(data, -1, -2)
    n = moved.shape[-2]
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], moved.shape)
    v_fwd, fwd = _fill_hillis(moved, idx, reverse=False)
    v_bwd, bwd = _fill_hillis(moved, idx, reverse=True)
    has_fwd = fwd >= 0
    has_bwd = bwd >= 0
    span = jnp.maximum(bwd - fwd, 1).astype(moved.dtype)
    interp = v_fwd + (idx - fwd).astype(moved.dtype) * (v_bwd - v_fwd) / span
    out = jnp.where(~jnp.isnan(moved), moved, jnp.where(
        has_fwd & has_bwd, interp, jnp.where(has_fwd, v_fwd, jnp.where(has_bwd, v_bwd, 0.0))
    ))
    return jnp.moveaxis(out, -2, -1).astype(data.dtype)


def _linearly_interpolate_nans(data):
    """Reference twodflag.py:240-251 — per-row interpolation across frequency."""
    return _linearly_interpolate_nans1d(data)


def _box_radii(sigma, passes: int) -> np.ndarray:
    """Quantized box radius per axis (reference twodflag.py:341)."""
    sigma = np.asarray(sigma, np.float64)
    return (0.5 * np.sqrt(12.0 * sigma**2 / passes + 1)).astype(np.int64)


def _box_sum_axis(x, r: int, axis: int):
    """Centred window sum of width 2r+1 along `axis`, zero padding."""
    d = 2 * r + 1
    dims = [1] * x.ndim
    dims[axis] = d
    padding = [(0, 0)] * x.ndim
    padding[axis] = (r, r)
    return lax.reduce_window(x, 0.0, lax.add, tuple(dims), (1,) * x.ndim, tuple(padding))


def _box_gaussian_filter(data, sigma, passes: int = 4):
    """Approximate Gaussian filter via repeated boxcars (Getreuer 2013).

    Reference twodflag.py:254-357.  Values outside the boundary are zero;
    the quantization of sigma matches the reference's radius formula.
    Summation is a local window sum per pass (``lax.reduce_window``) rather
    than the reference's long rolling sums, so no double-precision
    accumulator is needed.
    """
    sigma = np.asarray(sigma)
    if sigma.shape[0] != data.ndim:
        raise ValueError("sigma has wrong number of elements")
    r = _box_radii(sigma, passes)
    out = data
    for axis in range(data.ndim):
        ra = int(r[axis])
        if ra > 0:
            # Extend by the full K-pass support so mass that crosses the
            # boundary in early passes flows back in later ones (the
            # reference keeps its padded intermediate for the same reason,
            # twodflag.py:276-307).
            ext = ra * passes
            padding = [(0, 0)] * out.ndim
            padding[axis] = (ext, ext)
            out = jnp.pad(out, padding)
            for _ in range(passes):
                out = _box_sum_axis(out, ra, axis)
            sl = [slice(None)] * out.ndim
            sl[axis] = slice(ext, out.shape[axis] - ext)
            out = out[tuple(sl)] / jnp.asarray(float(2 * ra + 1) ** passes, data.dtype)
    return out


def masked_gaussian_filter(data, flags, sigma, passes: int = 4):
    """Gaussian filter ignoring flagged values (reference twodflag.py:359-400).

    Positions whose Gaussian support contains no unflagged data become NaN.
    The data and weight planes are filtered as ONE stacked (2, ...) array —
    half the window-sum ops, bitwise-identical per plane (the stack axis
    gets radius 0).
    """
    weight = (~flags).astype(data.dtype)
    filled = jnp.where(flags, 0.0, data)
    both = jnp.stack([filled, weight])
    sigma3 = np.concatenate([[0.0], np.asarray(sigma, np.float64)])
    fboth = _box_gaussian_filter(both, sigma3, passes)
    fd, fw = fboth[0], fboth[1]
    return jnp.where(fw == 0, jnp.nan, fd / fw)


def _get_background2d(data, flags, iterations: int, spike_width, reject_threshold,
                      freq_chunk_ends: np.ndarray):
    """Iteratively-masked smooth background (reference twodflag.py:403-463).

    Gaussian widths shrink linearly from ``iterations*spike_width`` down to
    ``spike_width``; outliers beyond ``reject_threshold`` MAD-sigmas (per
    frequency chunk) are masked each iteration.
    """
    spike_width = np.asarray(spike_width, np.float64)
    for extend_factor in range(iterations, 0, -1):
        background = masked_gaussian_filter(data, flags, extend_factor * spike_width)
        new_flags = []
        for c in range(len(freq_chunk_ends) - 1):
            lo, hi = int(freq_chunk_ends[c]), int(freq_chunk_ends[c + 1])
            sub_residual = jnp.abs(data[:, lo:hi] - background[:, lo:hi])
            threshold = _median_abs(sub_residual, flags[:, lo:hi])
            threshold = threshold * (MAD_NORMAL * reject_threshold)
            # NaN residuals (under existing flags) compare False — unflagged.
            new_flags.append(sub_residual > threshold)
        flags = flags | jnp.concatenate(new_flags, axis=1)
    background = masked_gaussian_filter(data, flags, spike_width)
    return _linearly_interpolate_nans(background).astype(jnp.float32)


def _dilate_full_windows(sum_flags, window: int, out_len: int):
    """OR each full-window outlier over the samples it covers.

    ``sum_flags`` has length ``out_len - window + 1`` along axis 0 (one per
    full window); result[i] = any window [k, k+window-1] containing i
    (reference _convolve_flags, twodflag.py:466-489).
    """
    pads = ((window - 1, window - 1),) + ((0, 0),) * (sum_flags.ndim - 1)
    padded = jnp.pad(sum_flags, pads)
    out = padded[:out_len]
    for j in range(1, window):
        out = out | padded[j : out_len + j]
    return out


def _sum_threshold1d(data, flags, windows, outlier_nsigma, rho, chunks: np.ndarray):
    """SumThreshold along axis 0 of (N, M) with per-chunk noise estimates.

    Reference twodflag.py:492-560: per chunk, an MAD noise estimate over the
    chunk, then for each window size: clamp previously-flagged samples to
    ±threshold, compare full-window means against the (falloff-scaled)
    threshold, and dilate outlier windows; positive and negative excursions
    are tracked separately.  Chunks overlap by ``max(windows) - 1`` samples.
    """
    n = data.shape[0]
    wmax = int(max(windows))
    out_parts = []
    for ci in range(len(chunks) - 1):
        lo, hi = int(chunks[ci]), int(chunks[ci + 1])
        if hi == lo:  # zero-length chunk (freq_chunks > channels)
            continue
        chunk_data = data[lo:hi]
        chunk_flags = flags[lo:hi]
        threshold0 = _median_abs_axis0(chunk_data, chunk_flags)[0]  # (M,)
        scale = outlier_nsigma * MAD_NORMAL
        threshold0 = jnp.where(jnp.isnan(threshold0), jnp.inf, threshold0 * scale)

        plo = max(lo - wmax + 1, 0)
        phi = min(hi + wmax - 1, n)
        pdata = data[plo:phi]
        p = phi - plo
        fpos = jnp.zeros(pdata.shape, bool)
        fneg = jnp.zeros(pdata.shape, bool)
        for window in [int(w) for w in windows]:
            if window > p:
                continue
            tf = np.float32(rho ** math.log2(window)) if window > 1 else np.float32(1.0)
            th = (threshold0 / tf)[None]  # (1, M)
            clamped = jnp.where(fpos & (pdata > th), th, pdata)
            clamped = jnp.where(fneg & (clamped < -th), -th, clamped)
            sums = clamped[: p - window + 1]
            for j in range(1, window):
                sums = sums + clamped[j : p - window + 1 + j]
            inv_w = np.float32(1.0 / window)
            fpos = fpos | _dilate_full_windows(sums * inv_w > th, window, p)
            fneg = fneg | _dilate_full_windows(sums * (-inv_w) > th, window, p)
        out_parts.append((fpos | fneg)[lo - plo : hi - plo])
    return jnp.concatenate(out_parts, axis=0)


def _sum_threshold(input_data, input_flags, axis: int, windows, outlier_nsigma, rho,
                   chunks: Optional[np.ndarray] = None):
    """Apply SumThreshold along `axis` (0 or 1) of a 2-D array
    (reference twodflag.py:563-631)."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if chunks is None:
        chunks = np.array([0, input_data.shape[axis]])
    windows = [int(w) for w in np.asarray(windows).ravel()]
    if not windows:
        return jnp.zeros(input_data.shape, bool)
    if axis == 0:
        return _sum_threshold1d(input_data, input_flags, windows, outlier_nsigma, rho, chunks)
    out = _sum_threshold1d(input_data.T, input_flags.T, windows, outlier_nsigma, rho, chunks)
    return out.T


def _dilate_centred(flags, extend: int, axis: int):
    """Centred boolean dilation of width `extend` with edge clipping
    (reference _combine_flags / _unaverage_freq smearing,
    twodflag.py:690-764)."""
    if extend <= 1:
        return flags
    lo = -(extend // 2)
    n = flags.shape[axis]
    out = flags
    for delta in range(lo, lo + extend):
        if delta == 0:
            continue
        shifted = jnp.roll(flags, -delta, axis=axis)
        # Zero out the wrapped region
        idx = jnp.arange(n)
        in_range = (idx + delta >= 0) & (idx + delta < n)
        shape = [1] * flags.ndim
        shape[axis] = n
        out = out | (shifted & in_range.reshape(shape))
    return out


def _combine_flags(spec_flags, time_flags, freq_flags, time_extend: int):
    """Combine flag sources and smear in time (reference twodflag.py:690-722)."""
    flag = spec_flags | time_flags | freq_flags
    return _dilate_centred(flag, int(time_extend), axis=0)


def _unaverage_freq(flags, freq_extend: int, average_freq: int,
                    flag_all_time_frac, flag_all_freq_frac, orig_freq: int):
    """Replicate averaged flags, smear in frequency, and fully flag
    over-flagged rows/columns (reference twodflag.py:725-764)."""
    n_time = flags.shape[0]
    rep = jnp.repeat(flags, average_freq, axis=1)[:, :orig_freq]
    dil = _dilate_centred(rep, int(freq_extend), axis=1)
    row_tot = jnp.sum(dil, axis=1)
    col_tot = jnp.sum(dil, axis=0)
    out = dil | (row_tot > flag_all_freq_frac * orig_freq)[:, None]
    out = out | (col_tot > n_time * flag_all_time_frac)[None, :]
    return out


def _get_baseline_flags(data, flags, *, outlier_nsigma, windows_time, windows_freq,
                        background_reject, background_iterations, spike_width_time,
                        spike_width_freq, time_extend, freq_extend, freq_chunk_ends,
                        average_freq, flag_all_time_frac, flag_all_freq_frac, rho,
                        orig_freq):
    """Flag one baseline (reference twodflag.py:767-881)."""
    # 1. median spectrum → background → SumThreshold in frequency
    spec_data, spec_flags = _time_median(data, flags)
    spec_background = _get_background2d(
        spec_data, spec_flags, background_iterations,
        np.array((0.0, spike_width_freq)), background_reject, freq_chunk_ends,
    )
    spec_data = spec_data - spec_background
    spec_flags = _sum_threshold(
        spec_data, spec_flags, 1, windows_freq, outlier_nsigma, rho, freq_chunk_ends
    )
    flags = flags | spec_flags

    # 2. 2-D background, subtract
    background = _get_background2d(
        data, flags, background_iterations,
        np.array((spike_width_time, spike_width_freq)), background_reject, freq_chunk_ends,
    )
    data = data - background

    # 3. SumThreshold in time, then frequency (with time flags folded in)
    time_flags = _sum_threshold(data, flags, 0, windows_time, outlier_nsigma, rho)
    flags = flags | time_flags
    freq_flags = _sum_threshold(
        data, flags, 1, windows_freq, outlier_nsigma, rho, freq_chunk_ends
    )

    # 4. combine + smear + un-average
    combined = _combine_flags(spec_flags, time_flags, freq_flags, time_extend)
    return _unaverage_freq(
        combined, freq_extend, average_freq, flag_all_time_frac, flag_all_freq_frac, orig_freq
    )


class SumThresholdFlagger:
    """Flagger that detects spikes in both frequency and time axes.

    It uses the SumThreshold method (Offringa, A., MNRAS, 405, 155-167,
    2010).  Parameters are identical to the reference
    (twodflag.py:951-984); see the module docstring for the algorithm.
    """

    def __init__(self, outlier_nsigma=4.5, windows_time=[1, 2, 4, 8],
                 windows_freq=[1, 2, 4, 8], background_reject=2.0,
                 background_iterations=1, spike_width_time=12.5, spike_width_freq=10.0,
                 time_extend=3, freq_extend=3, freq_chunks=10, average_freq=1,
                 flag_all_time_frac=0.6, flag_all_freq_frac=0.8, rho=1.3):
        self.outlier_nsigma = outlier_nsigma
        self.windows_time = windows_time
        # Scale the frequency windows and remove duplicates (reference
        # twodflag.py:970-972).
        windows_freq = np.ceil(np.array(windows_freq, dtype=np.float32) / average_freq)
        self.windows_freq = np.unique(windows_freq.astype(np.int_))
        self.background_reject = background_reject
        self.background_iterations = background_iterations
        self.spike_width_time = spike_width_time
        self.spike_width_freq = spike_width_freq / average_freq
        self.time_extend = int(time_extend)
        self.freq_extend = int(freq_extend)
        self.freq_chunks = freq_chunks
        self.average_freq = int(average_freq)
        self.flag_all_time_frac = flag_all_time_frac
        self.flag_all_freq_frac = flag_all_freq_frac
        self.rho = rho
        self._impl_cache = {}

    def _impl(self, shape):
        """Shape-specialized jitted implementation over a (T, F, BL) block."""
        if shape in self._impl_cache:
            return self._impl_cache[shape]
        n_time, n_freq, n_bl = shape
        averaged_channels = -(-n_freq // self.average_freq)
        freq_chunk_ends = np.linspace(0, averaged_channels, self.freq_chunks + 1).astype(np.int_)
        # Clip windows to the data extents (reference twodflag.py:1005-1007,
        # including its use of the *frequency* extent for windows_time).
        windows_time = np.array([w for w in self.windows_time if w <= n_freq], np.int_)
        windows_freq = np.array(
            [w for w in self.windows_freq if w <= averaged_channels], np.int_
        )

        per_baseline = functools.partial(
            _get_baseline_flags,
            outlier_nsigma=self.outlier_nsigma,
            windows_time=windows_time,
            windows_freq=windows_freq,
            background_reject=self.background_reject,
            background_iterations=self.background_iterations,
            spike_width_time=self.spike_width_time,
            spike_width_freq=self.spike_width_freq,
            time_extend=self.time_extend,
            freq_extend=self.freq_extend,
            freq_chunk_ends=freq_chunk_ends,
            average_freq=self.average_freq,
            flag_all_time_frac=self.flag_all_time_frac,
            flag_all_freq_frac=self.flag_all_freq_frac,
            rho=self.rho,
            orig_freq=n_freq,
        )

        @jax.jit
        def impl(in_data, in_flags):
            avg_data, avg_flags = _average_freq(in_data, in_flags, self.average_freq)
            tmp = jax.vmap(per_baseline)(avg_data, avg_flags)  # (bl, time, freq)
            out = jnp.moveaxis(tmp, 0, -1)
            # For complex input the reference flags isnan(re)|isnan(im)
            # (twodflag.py:687); isnan(abs(x)) would miss e.g. inf+nan·j
            # (whose magnitude is inf).
            if jnp.iscomplexobj(in_data):
                nan_in = jnp.isnan(jnp.real(in_data)) | jnp.isnan(jnp.imag(in_data))
            else:
                nan_in = jnp.isnan(in_data)
            return out | nan_in

        self._impl_cache[shape] = impl
        return impl

    def get_flags_sharded(self, data, flags, mesh, axis_name: Optional[str] = None):
        """Multi-chip :meth:`get_flags`: baselines sharded over `mesh`.

        New capability (SURVEY.md §2.5): the reference parallelizes the
        same baseline axis with host thread/process pools
        (twodflag.py:1029-1118); here each chip flags its baseline shard.
        Per-baseline independence means XLA partitions the program with
        ZERO collectives — scaling is embarrassing by construction.

        `axis_name` selects the mesh axis to shard baselines over
        (default: the mesh's first axis); other mesh axes replicate.  The
        baseline count is padded up to a multiple of the axis size and
        the pad is cropped from the result.

        Works across processes too (a multi-host mesh): every process
        passes the full (replicated) host cube, each device takes its
        shard, and the flags are allgathered back to every process
        (tests/multihost_worker.py exercises this over two real
        processes).
        """
        from jax.sharding import NamedSharding, PartitionSpec

        data = np.asarray(data) if not isinstance(data, jnp.ndarray) else data
        if data.shape != flags.shape:
            raise ValueError("Shape mismatch")
        if data.ndim != 3:
            raise ValueError("data has wrong number of dimensions")
        axis_name = axis_name or mesh.axis_names[0]
        n_shards = mesh.shape[axis_name]
        n_bl = data.shape[-1]
        pad = (-n_bl) % n_shards
        if pad:
            data = np.concatenate([np.asarray(data)] + [np.asarray(data[..., -1:])] * pad, -1)
            flags = np.concatenate([np.asarray(flags)] + [np.asarray(flags[..., -1:])] * pad, -1)
        data, flags = np.asarray(data), np.asarray(flags)
        impl = self._impl(data.shape)
        spec = PartitionSpec(None, None, axis_name)
        sharding = NamedSharding(mesh, spec)
        sharded = jax.jit(
            lambda d, f: impl(d, f),
            in_shardings=(sharding, sharding),
            out_shardings=sharding,
        )
        d = jax.make_array_from_callback(data.shape, sharding, lambda idx: data[idx])
        f = jax.make_array_from_callback(flags.shape, sharding, lambda idx: flags[idx])
        out = sharded(d, f)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            out = multihost_utils.process_allgather(out, tiled=True)
        return np.asarray(out)[..., :n_bl]

    def get_flags(self, data, flags, pool=None, chunk_size=None, is_multiprocess=None):
        """Compute flags for a (time, frequency, baseline) cube.

        `pool` and `is_multiprocess` are accepted for reference API
        compatibility (twodflag.py:1029-1118) and ignored: the baseline axis
        is batched on-device (vmap) instead of fanned out to host worker
        pools.  `chunk_size` bounds the number of baselines processed per
        device dispatch (memory control).
        """
        data = np.asarray(data) if not isinstance(data, jnp.ndarray) else data
        if data.shape != flags.shape:
            raise ValueError("Shape mismatch")
        if data.ndim != 3:
            raise ValueError("data has wrong number of dimensions")
        n_bl = data.shape[-1]
        if not chunk_size:
            chunk_size = min(n_bl, 16)
        out = np.empty(data.shape, np.bool_)
        for i in range(0, n_bl, chunk_size):
            chunk = slice(i, min(i + chunk_size, n_bl))
            block = jnp.asarray(data[..., chunk])
            block_flags = jnp.asarray(np.asarray(flags[..., chunk]))
            impl = self._impl(block.shape)
            out[..., chunk] = np.asarray(impl(block, block_flags))
        return out
