"""Device implementations of the RFI flagging pipeline.

Mirrors the reference's device flagger framework (reference:
src/katsdpsigproc/rfi/device.py): per-stage Template/Operation pairs with a
``transposed`` memory-order attribute and ``host_class`` back-pointers,
``*HostFromDevice`` wrappers presenting the host oracle API over device
implementations, and a composed ``FlaggerDevice`` pipeline.

Design choices (not a translation):

* **Background median filter** (reference
  rfi/background_median_filter.mako:79-220 — a serial sliding rank-
  maintenance window per thread): reformulated as a *vectorized windowed
  median* over the ``width`` shifted copies of the amplitude array,
  fully data-parallel.  The default engine is a Batcher sorting
  network pruned to the median's cone of influence
  (``ops.rank.selection_network``); a compare-count ranking engine is
  selectable (see :func:`masked_median_filter` for the
  tradeoff).  Flagged samples become NaN (the reference's ``-1``
  sentinel) and drop out of the valid count exactly as the reference's
  ``num_valid`` bookkeeping does.
* **MAD noise estimation** (reference rfi/madnz_t.mako:72-87): the same
  bitwise IEEE-754 binary search as the reference, fully vectorized over
  baselines (see :mod:`katsdpsigproc_tpu.ops.rank`).
* **SumThreshold** (reference rfi/threshold_sum.mako:49-132 — Kogge-Stone
  ladders in local memory): expressed as shifted-window sums and boolean
  dilations along the channel axis — elementwise chains that XLA
  fuses; no barriers, no local memory, no ``EDGE_SIZE`` halo bookkeeping
  (the whole baseline is resident).  Window sums use direct shifted adds
  (not cumsum differences) so float behaviour tracks the host oracle's
  ``np.convolve``.
* **Layout**: stages declare ``transposed`` (baseline-major) like the
  reference, and ``FlaggerDevice`` inserts transposes where stage layouts
  disagree (reference rfi/device.py:1026-1037,1135-1164) — but since the
  whole pipeline is one jitted XLA program, those transposes are layout
  changes for the compiler, not extra HBM round-trips.

Each stage runs under a :func:`jax.named_scope` named after its function
(``background_median_filter``, ``madnz``, ``threshold_sum``), so profiler
traces and compiled HLO metadata attribute device time to stages.
"""

import enum
from typing import Any, Mapping, Optional, Type, Union

import jax
import jax.numpy as jnp
import numpy as np

from ...ops import base, rank as rank_ops, transpose as transpose_ops
from ...utils import tune
from . import MAD_NORMAL, host


class BackgroundFlags(enum.Enum):
    """Input-flag modes for backgrounding (reference rfi/device.py:40-46)."""

    NONE = 0
    CHANNEL = 1
    FULL = 2

    def __bool__(self):
        return self != BackgroundFlags.NONE


# ---------------------------------------------------------------------------
# Functional kernels
# ---------------------------------------------------------------------------


def masked_median_filter(amp, width: int, engine: str = "network",
                         edges_only: bool = False):
    """Centred windowed median along axis 0, NaN = absent, min_periods=1.

    `amp` is (channels, baselines) float32 with NaN marking flagged/absent
    samples.  Returns (median, valid_count) where `median` is NaN for
    windows with no valid samples.  Matches the reference's sliding filter
    semantics (background_median_filter.mako:96-145): even valid counts
    average the two middle values.

    ``edges_only=True`` asserts `amp` itself is NaN-free, so members are
    absent only where the window truncates at the channel edges.  Then the
    NaN pads are replaced with a **static alternating ±inf vector** (the
    ``k`` absent members of an edge window get ``ceil(k/2)`` −inf and
    ``floor(k/2)`` +inf fills), which pins the truncated-window median at
    the fixed sorted ranks ``width//2`` / ``width//2 + 1`` of the padded
    window: with ``a`` fills below, valid rank ``r`` lands at ``a + r``
    and ``a + (n−1)//2 == width//2`` identically.  The per-element
    valid-count pass and the rank-indexed selection loop disappear
    (bit-identical results — the same elements are selected).

    Both engines keep the window stack out of device memory (every term
    is a shifted elementwise op XLA fuses into one loop; an axis sort
    would materialize ``width`` full copies):

    * ``"network"`` (default) — Batcher odd-even sort of the +inf-masked
      members, pruned to the lower-half outputs that the median selection
      can touch (78 vector min/max ops for width 13, vs 96 for the full
      sort — ``ops.rank.selection_network``), followed by rank-indexed
      selection of the two middle valid entries.
    * ``"count"`` — compare-count ranking: each member's stable rank
      among valid members is its count of pairwise wins (ties to the
      earlier position); O(width²) compares, wide and shallow.
    """
    h = width // 2
    c = amp.shape[0]
    if edges_only and engine == "network" and width % 2 == 1 and c >= width:
        # A member at signed offset d is absent at channel `col` when
        # col + d is out of range; its fill must be −inf iff the
        # out-of-range distance is odd.  In pad coordinates that distance
        # is a *static* function of the pad index, so the pads are
        # constants: left pad index p (0-based) fills −inf iff (h−p) odd;
        # right pad index q fills −inf iff (q+1) odd.
        trail = (1,) * (amp.ndim - 1)
        inf = np.float32(np.inf)
        left = jnp.asarray(
            np.where((h - np.arange(h)) % 2 == 1, -inf, inf).astype(np.float32)
        ).reshape((h,) + trail)
        right = jnp.asarray(
            np.where((np.arange(h) + 1) % 2 == 1, -inf, inf).astype(np.float32)
        ).reshape((h,) + trail)
        bshape = (h,) + amp.shape[1:]
        padded = jnp.concatenate(
            [jnp.broadcast_to(left, bshape), amp, jnp.broadcast_to(right, bshape)], axis=0
        )
        arrs = [padded[k : k + c] for k in range(width)]
        rank_ops.apply_selection_network(
            arrs, rank_ops.selection_network(width, (h, h + 1)))
        col = jnp.arange(c, dtype=jnp.int32)
        k_abs = jnp.maximum(h - col, 0) + jnp.maximum(col - (c - 1 - h), 0)
        n = jnp.broadcast_to(
            (width - k_abs).reshape((c,) + trail), amp.shape)
        n_odd = ((k_abs & 1) == 0).reshape((c,) + trail)
        med = jnp.where(n_odd, arrs[h], (arrs[h] + arrs[h + 1]) * jnp.float32(0.5))
        return med, n
    padded = jnp.pad(amp, ((h, h),) + ((0, 0),) * (amp.ndim - 1), constant_values=jnp.nan)
    win = [padded[k : k + c] for k in range(width)]
    nan = [jnp.isnan(w) for w in win]
    n = sum((~m).astype(jnp.int32) for m in nan)
    lo = (n - 1) // 2
    hi = n // 2
    zero = jnp.zeros(amp.shape, amp.dtype)
    v_lo = zero
    v_hi = zero
    if engine == "network":
        inf = jnp.float32(np.inf)
        arrs = [jnp.where(m, inf, w) for w, m in zip(win, nan)]
        # Only the lower half of the sort is ever selected (hi = n//2 ≤
        # width//2), so run the Batcher network pruned to those outputs.
        rank_ops.apply_selection_network(arrs, rank_ops.selection_network(
            width, range(width // 2 + 1)))
        # After the (partial) sort the valid members occupy positions
        # 0..n-1 ascending (absent members are +inf, pushed to the top).
        # A selected rank k < n always holds a finite member; +inf is
        # selected only when n == 0, where the n > 0 guard below replaces
        # the (then infinite) median with NaN anyway — no inf-masking.
        for k in range(width // 2 + 1):
            v_lo = v_lo + jnp.where(lo == k, arrs[k], 0.0)
            v_hi = v_hi + jnp.where(hi == k, arrs[k], 0.0)
    elif engine == "count":
        for j in range(width):
            # Stable rank of win[j] among valid members: NaN comparisons
            # are False, so invalid members never count; ties go to the
            # earlier position.  NaN members get rank n (never selected).
            r = jnp.zeros(amp.shape, jnp.int32)
            for k in range(width):
                if k == j:
                    continue
                if k < j:
                    r = r + (win[k] <= win[j])
                else:
                    r = r + (win[k] < win[j])
            vj = jnp.where(nan[j], 0.0, win[j])
            v_lo = v_lo + jnp.where(~nan[j] & (r == lo), vj, 0.0)
            v_hi = v_hi + jnp.where(~nan[j] & (r == hi), vj, 0.0)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    med = (v_lo + v_hi) * 0.5
    return jnp.where(n > 0, med, jnp.nan), n


def amplitude(vis):
    """|vis| for complex or planar (trailing-pair float32) visibilities.

    Complex visibilities may come as complex64 or *split-complex*: a
    trailing length-2 float32 axis (re, im), the planar image of
    interleaved complex64.
    """
    if jnp.issubdtype(vis.dtype, jnp.complexfloating):
        return jnp.abs(vis).astype(jnp.float32)
    if vis.shape[-1] == 2 and not jnp.issubdtype(vis.dtype, jnp.complexfloating):
        re = vis[..., 0].astype(jnp.float32)
        im = vis[..., 1].astype(jnp.float32)
        return jnp.sqrt(re * re + im * im)
    raise TypeError("expected complex input or a trailing (re, im) pair axis")


def to_planar(vis):
    """Convert a complex numpy/JAX array to the planar float32 layout.

    The trailing (…, 2) layout is the planar image of interleaved
    complex64, i.e. what the reference's device buffers hold.
    """
    if isinstance(vis, np.ndarray):
        return np.stack([vis.real.astype(np.float32), vis.imag.astype(np.float32)], axis=-1)
    return jnp.stack([vis.real.astype(jnp.float32), vis.imag.astype(jnp.float32)], axis=-1)


@jax.named_scope("background_median_filter")
def background_median_filter(vis, flags, width: int, is_amplitude: bool,
                             use_flags: BackgroundFlags, engine: str = "network",
                             fast_path: Optional[bool] = None):
    """Deviations from a windowed-median background (channels, baselines).

    Semantics follow the reference kernel (background_median_filter.mako):
    flagged inputs (and, for amplitude input, negative values) are excluded
    from the median and map to 0 in the output; the output elsewhere is
    ``amp - median(valid window)``.  Complex visibilities may be passed as
    complex64 or in the planar (channels, baselines, 2) float32 layout.
    `engine` selects the windowed-median engine (see
    :func:`masked_median_filter`) — the tuning dimension of
    :class:`BackgroundMedianFilterDeviceTemplate`.

    ``fast_path`` gates the no-input-flags edge-fill fast path (which
    skips the valid-count pass, rank selection, and NaN post-fill).  The
    two paths are bit-identical.  ``None`` keeps it on where applicable.
    """
    if fast_path is None:
        fast_path = True
    if fast_path and not is_amplitude and use_flags == BackgroundFlags.NONE:
        # Statically NaN-free input: the edge-fill fast path skips the
        # valid-count pass, the rank selection, and the NaN post-fill.
        amp = amplitude(vis)
        med, _ = masked_median_filter(amp, width, engine, edges_only=True)
        return (amp - med).astype(jnp.float32)
    if is_amplitude:
        amp = vis.astype(jnp.float32)
        invalid = amp < 0
    else:
        amp = amplitude(vis)
        invalid = jnp.zeros(amp.shape, bool)
    if use_flags == BackgroundFlags.CHANNEL:
        invalid = invalid | (flags != 0)[:, None]
    elif use_flags == BackgroundFlags.FULL:
        invalid = invalid | (flags != 0)
    amp = jnp.where(invalid, jnp.nan, amp)
    med, _ = masked_median_filter(amp, width, engine)
    deviations = amp - med
    return jnp.where(jnp.isnan(deviations), 0.0, deviations).astype(jnp.float32)


@jax.named_scope("madnz")
def madnz(deviations_t, n_channels: Optional[int] = None, axis: int = -1,
          radix_bits: int = 4):
    """MAD noise per baseline from deviations, channels along `axis`.

    ``MAD_NORMAL * median(nonzero |deviations|)`` with the reference's exact
    rank arithmetic (rank.mako:253-267).  ``axis=-1`` expects the transposed
    (baselines, channels) layout (madnz_t.mako:72-87); ``axis=0`` is the
    straight (channels, baselines) layout (madnz.mako:105-123) — no corner
    turn needed.  `radix_bits` is the rank-search digit width
    (:func:`katsdpsigproc_tpu.ops.rank.find_rank_float`) — the tuning
    dimension of the noise-estimate templates; every value gives the
    bit-identical exact median.
    """
    values = jnp.abs(deviations_t).astype(jnp.float32)
    med = rank_ops.median_non_zero(values, n_channels, axis=axis, radix_bits=radix_bits)
    return (MAD_NORMAL * med).astype(jnp.float32)


def threshold_simple(deviations, noise, n_sigma: float, flag_value: int = 1, transposed=False):
    """Elementwise ``deviations > n_sigma * noise`` (reference threshold_simple.mako)."""
    noise_b = noise[None, :] if not transposed else noise[:, None]
    return jnp.where(deviations > n_sigma * noise_b, jnp.uint8(flag_value), jnp.uint8(0))


@jax.named_scope("threshold_sum")
def threshold_sum(
    deviations_t,
    noise,
    n_sigma: float,
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    transposed: bool = True,
):
    """SumThreshold on deviations; channels along the last axis when
    `transposed` (baselines, channels), else along axis 0.

    Matches the host oracle exactly (host.py ThresholdSumHost /
    reference rfi/host.py:186-254): full windows only; flagged samples are
    clamped to the current threshold; flags disperse over every sample
    covered by an outlier window.  Window sums are direct shifted adds and
    the dispersal is a boolean dilation — all fusable elementwise work
    (cf. threshold_sum.mako:84-121's local-memory Kogge-Stone ladders).
    """
    ax = deviations_t.ndim - 1 if transposed else 0
    channels = deviations_t.shape[ax]

    def sl(x, start, stop):
        return jax.lax.slice_in_dim(x, start, stop, axis=ax)

    flags = jnp.zeros(deviations_t.shape, bool)
    base_threshold = jnp.expand_dims((n_sigma * noise).astype(jnp.float32), ax)
    for w in range(n_windows):
        window = 1 << w
        if window > channels:
            break
        threshold = (base_threshold * np.float32(threshold_falloff ** -w)).astype(jnp.float32)
        clamped = jnp.where(flags, threshold, deviations_t)

        # sums[k] = sum(clamped[k : k + window]), k in [0, channels - window].
        # Kogge-Stone doubling: log2(window) shifted adds instead of
        # window - 1 (slices never wrap, so no cross-boundary garbage).
        sums = clamped
        length = channels
        done = 1
        while done < window:
            length -= done
            sums = sl(sums, 0, length) + sl(sums, done, length + done)
            done *= 2
        sum_flags = sums > threshold * window
        # flag[c] |= any(sum_flags[max(0, c-window+1) : min(c, channels-window) + 1])
        pad = [(0, 0)] * sum_flags.ndim
        pad[ax] = (window - 1, window - 1)
        new_flags = jnp.pad(sum_flags, pad)
        length = channels + window - 1
        done = 1
        while done < window:
            length -= done
            new_flags = sl(new_flags, 0, length) | sl(new_flags, done, length + done)
            done *= 2
        flags = flags | new_flags
    return jnp.where(flags, jnp.uint8(flag_value), jnp.uint8(0))


def make_flagger_fn(
    width: int = 13,
    n_sigma: float = 11.0,
    is_amplitude: bool = False,
    use_flags: "BackgroundFlags" = None,
    threshold: str = "sum",
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    baseline_block: Optional[int] = None,
    layout: str = "straight",
    block_impl: str = "pad",
    background_fast: Optional[bool] = None,
):
    """Build the fused single-device flagger: one jitted fn, zero HBM round-trips
    for intermediates beyond what XLA chooses.

    This is the performance path (the reference's equivalent is the
    OperationSequence of five kernels, rfi/device.py:1135-1164, which
    round-trips deviations/noise/flags through global memory between
    kernels).  `baseline_block` processes the baseline axis in sequential
    blocks to bound peak memory for very large dumps; ``block_impl``
    selects padded slicing (``"pad"``, default — rounds the block up to a
    multiple of 128 and zero-pads the baseline axis so every slab has the
    same aligned shape), exact-size dynamic slicing (``"slice"``), a
    stacked ``lax.scan`` (``"scan"``), or a static Python loop
    (``"unroll"``).  ``layout`` selects the stage memory order after the
    background filter — the reference's madnz.mako ("straight", default:
    noise/threshold run channel-major, zero transposes) vs madnz_t.mako
    ("transposed") pairing.  All layouts and block impls are
    bit-identical.  ``background_fast`` selects the background filter's
    edge-fill fast path (see :func:`background_median_filter`; default
    off).

    Returns ``fn(vis[, input_flags]) -> flags`` on (channels, baselines).
    """
    use_flags = BackgroundFlags.NONE if use_flags is None else use_flags
    if layout not in ("transposed", "straight"):
        raise ValueError(f"unknown layout {layout!r}")
    if background_fast is None:
        background_fast = False

    def block_fn(vis, input_flags=None):
        deviations = background_median_filter(
            vis, input_flags, width, is_amplitude, use_flags,
            fast_path=background_fast,
        )
        if layout == "straight":
            # Channel-major throughout — the reference's madnz.mako layout:
            # no corner turn of deviations or flags.
            noise = madnz(deviations, axis=0)
            if threshold == "simple":
                return threshold_simple(deviations, noise, n_sigma, flag_value, False)
            return threshold_sum(
                deviations, noise, n_sigma, n_windows, threshold_falloff, flag_value,
                transposed=False,
            )
        dev_t = jnp.swapaxes(deviations, 0, 1)
        noise = madnz(dev_t)
        if threshold == "simple":
            flags_t = threshold_simple(dev_t, noise, n_sigma, flag_value, True)
        else:
            flags_t = threshold_sum(
                dev_t, noise, n_sigma, n_windows, threshold_falloff, flag_value
            )
        return jnp.swapaxes(flags_t, 0, 1)

    if baseline_block is None:
        return jax.jit(block_fn)
    if block_impl not in ("slice", "scan", "unroll", "pad"):
        raise ValueError(f"unknown block_impl {block_impl!r}")

    def slab(v, f):
        # `f` is the per-slab FULL flags slice, or the shared CHANNEL
        # flags vector, or None.
        if use_flags == BackgroundFlags.NONE:
            return block_fn(v)
        return block_fn(v, f)

    def blocked_slice(vis, input_flags=None):
        # Baseline-axis blocking without any corner turn: a fori_loop
        # dynamic-slices each (channels, block) slab out of the caller's
        # layout and dynamic-updates the flags in place.  The lax.scan
        # alternative must first materialize a (nb, c, block) stack —
        # at MeerKAT scale that is a 528 MB transpose read+written before
        # any flagging starts, plus the inverse reorg of the flags.
        c, b = vis.shape[:2]
        nb = b // baseline_block

        def body(i, out):
            start = i * baseline_block
            v = jax.lax.dynamic_slice_in_dim(vis, start, baseline_block, axis=1)
            f = input_flags
            if use_flags == BackgroundFlags.FULL and input_flags is not None:
                f = jax.lax.dynamic_slice_in_dim(input_flags, start, baseline_block, axis=1)
            return jax.lax.dynamic_update_slice_in_dim(out, slab(v, f), start, axis=1)

        out = jnp.zeros((c, b), jnp.uint8)
        out = jax.lax.fori_loop(0, nb, body, out)
        if nb * baseline_block < b:
            tail = vis[:, nb * baseline_block :]
            tail_flags = input_flags
            if use_flags == BackgroundFlags.FULL and input_flags is not None:
                tail_flags = input_flags[:, nb * baseline_block :]
            out = jax.lax.dynamic_update_slice_in_dim(
                out, slab(tail, tail_flags), nb * baseline_block, axis=1
            )
        return out

    def blocked_scan(vis, input_flags=None):
        # Corner-turn variant: stack the slabs and lax.scan over them.
        c, b = vis.shape[:2]
        pair = vis.shape[2:]  # () for complex/amplitude, (2,) for planar
        nb = b // baseline_block
        main = vis[:, : nb * baseline_block]
        blocks = jnp.moveaxis(main.reshape((c, nb, baseline_block) + pair), 1, 0)
        per_block_flags = None
        if use_flags == BackgroundFlags.FULL and input_flags is not None:
            f_main = input_flags[:, : nb * baseline_block]
            per_block_flags = jnp.moveaxis(f_main.reshape(c, nb, baseline_block), 1, 0)

        def body(_, xs):
            v, f = xs if per_block_flags is not None else (xs, input_flags)
            return None, slab(v, f)

        xs = (blocks, per_block_flags) if per_block_flags is not None else blocks
        _, out = jax.lax.scan(body, None, xs)
        out = jnp.moveaxis(out, 0, 1).reshape(c, nb * baseline_block)
        if nb * baseline_block < b:
            tail = vis[:, nb * baseline_block :]
            tail_flags = input_flags
            if use_flags == BackgroundFlags.FULL and input_flags is not None:
                tail_flags = input_flags[:, nb * baseline_block :]
            out = jnp.concatenate([out, slab(tail, tail_flags)], axis=1)
        return out

    def blocked_unroll(vis, input_flags=None):
        # Fully static variant: a Python loop over compile-time slab
        # starts (lax.slice, not dynamic_slice) with one concatenate at
        # the end.  Static offsets let XLA fuse the slab extraction into
        # the background filter's read (no slab copy) at the cost of nb
        # copies of the pipeline in the module (compile time scales with
        # nb — keep for small slab counts).
        c, b = vis.shape[:2]
        outs = []
        for start in range(0, b, baseline_block):
            stop = min(start + baseline_block, b)
            v = jax.lax.slice_in_dim(vis, start, stop, axis=1)
            f = input_flags
            if use_flags == BackgroundFlags.FULL and input_flags is not None:
                f = jax.lax.slice_in_dim(input_flags, start, stop, axis=1)
            outs.append(slab(v, f))
        return jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]

    def blocked_pad(vis, input_flags=None):
        # Aligned variant of blocked_slice: pad the baseline axis so every
        # slab start is a multiple of 128 and every slab has one shape.
        # Baselines are independent, so zero-padding is exact (pad
        # columns' flags are cropped).
        c, b = vis.shape[:2]
        slab_a = -(-baseline_block // 128) * 128
        nb = -(-b // slab_a)
        b_pad = nb * slab_a
        pad = [(0, 0)] * vis.ndim
        pad[1] = (0, b_pad - b)
        vp = jnp.pad(vis, pad)
        fp = input_flags
        if use_flags == BackgroundFlags.FULL and input_flags is not None:
            fp = jnp.pad(input_flags, [(0, 0), (0, b_pad - b)])

        def body(i, out):
            start = i * slab_a
            v = jax.lax.dynamic_slice_in_dim(vp, start, slab_a, axis=1)
            f = fp
            if use_flags == BackgroundFlags.FULL and fp is not None:
                f = jax.lax.dynamic_slice_in_dim(fp, start, slab_a, axis=1)
            return jax.lax.dynamic_update_slice_in_dim(out, slab(v, f), start, axis=1)

        out = jax.lax.fori_loop(0, nb, body, jnp.zeros((c, b_pad), jnp.uint8))
        return out[:, :b]

    impl = {"slice": blocked_slice, "scan": blocked_scan, "unroll": blocked_unroll,
            "pad": blocked_pad}
    return jax.jit(impl[block_impl])


def spectral_flag(x, n_sigma: float = 5.0):
    """FFT-path spectral flagging of real series, samples along the last axis.

    Per row: r2c FFT → flag the bins whose amplitude exceeds `n_sigma`
    MAD-sigmas of the row's non-zero bin amplitudes → zero the flagged
    bins → c2r inverse.  Returns ``(flags, cleaned)``: uint8 flags of shape
    ``(..., n // 2 + 1)`` and the cleaned float32 series.
    """
    n = x.shape[-1]
    spectrum = jnp.fft.rfft(x, axis=-1)
    amp = jnp.abs(spectrum).astype(jnp.float32)
    noise = MAD_NORMAL * rank_ops.median_non_zero(amp)
    flags = amp > n_sigma * noise[..., None]
    cleaned = jnp.fft.irfft(jnp.where(flags, 0.0, spectrum), n=n, axis=-1)
    return flags.astype(jnp.uint8), cleaned.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Stage templates / operations
# ---------------------------------------------------------------------------


class AbstractBackgroundDevice(base.Operation):
    """Instance-level background-stage contract (reference rfi/device.py:49-62)."""


class AbstractNoiseEstDevice(base.Operation):
    """Instance-level noise-estimate contract (reference rfi/device.py:65-78)."""


class AbstractThresholdDevice(base.Operation):
    """Instance-level threshold contract (reference rfi/device.py:81-95)."""


class AbstractBackgroundDeviceTemplate:
    use_flags: BackgroundFlags
    host_class: Type[host.AbstractBackgroundHost]

    def instantiate(self, command_queue, channels, baselines, allocator=None):
        raise NotImplementedError  # pragma: nocover


class AbstractNoiseEstDeviceTemplate:
    transposed: bool
    host_class: Type[host.AbstractNoiseEstHost]

    def instantiate(self, command_queue, channels, baselines, allocator=None):
        raise NotImplementedError  # pragma: nocover


class AbstractThresholdDeviceTemplate:
    transposed: bool
    host_class: Type[host.AbstractThresholdHost]

    def instantiate(self, command_queue, channels, baselines, n_sigma, *, allocator=None):
        raise NotImplementedError  # pragma: nocover


class BackgroundMedianFilterDeviceTemplate(AbstractBackgroundDeviceTemplate):
    """Device backgrounder: windowed-median filter per baseline (by amplitude).

    Reference: rfi/device.py:141-263.  The tuning knob is the windowed-
    median ``engine`` — selection ``"network"`` vs compare-``"count"``
    (see :func:`masked_median_filter`); the reference tunes
    ``wgs``/``csplit`` (rfi/device.py:211-252), work-group knobs with no
    XLA analogue.

    Parameters
    ----------
    context
        Placement context.
    width
        The kernel width (must be odd).
    is_amplitude
        If true, inputs are amplitudes rather than complex visibilities.
    use_flags
        NONE / CHANNEL / FULL input-flag mode (bool accepted as alias).
    """

    host_class = host.BackgroundMedianFilterHost
    autotune_version = 5

    def __init__(self, context, width: int, is_amplitude: bool = False,
                 use_flags: Union[BackgroundFlags, bool] = BackgroundFlags.NONE, tuning=None):
        self.context = context
        self.width = width
        self.is_amplitude = is_amplitude
        if use_flags is True:
            use_flags = BackgroundFlags.CHANNEL
        elif use_flags is False:
            use_flags = BackgroundFlags.NONE
        if not isinstance(use_flags, BackgroundFlags):
            raise TypeError("use_flags must be an instance of BackgroundFlags or bool")
        self.use_flags = use_flags
        if tuning is None:
            tuning = self.autotune(context, width)
        self.engine = tuning.get("engine", "network")

    @classmethod
    @tune.autotuner(test={"engine": "network"})
    def autotune(cls, context, width) -> Mapping[str, Any]:
        # Measured engine search (both engines are mask-exact).
        import functools

        rs = np.random.RandomState(2021)
        amp = jnp.asarray(np.abs(rs.standard_normal((4096, 512))).astype(np.float32))

        def generate(engine):
            fn = jax.jit(functools.partial(masked_median_filter, width=width, engine=engine))
            jax.block_until_ready(fn(amp))  # fail now if the engine can't compile
            return tune.make_measure(fn, amp)

        return tune.autotune(generate, engine=["network", "count"])

    def instantiate(self, command_queue=None, channels=0, baselines=0, allocator=None):
        return BackgroundMedianFilterDevice(self, channels, baselines)


class BackgroundMedianFilterDevice(AbstractBackgroundDevice):
    """Concrete background op (reference rfi/device.py:265-333).

    .. rubric:: Slots

    **vis** : (channels, baselines) float32 or complex64
    **flags** : (channels, baselines) or (channels,) uint8 — only with use_flags
    **deviations** : (channels, baselines) float32, output
    """

    def __init__(self, template: BackgroundMedianFilterDeviceTemplate, channels, baselines):
        super().__init__()
        self.template = template
        self.channels = channels
        self.baselines = baselines
        vis_type = jnp.float32 if template.is_amplitude else jnp.complex64
        shape = (channels, baselines)
        self.slots["vis"] = base.Slot(shape, vis_type, base.Direction.IN)
        self.slots["deviations"] = base.Slot(shape, jnp.float32, base.Direction.OUT)
        if template.use_flags == BackgroundFlags.FULL:
            self.slots["flags"] = base.Slot(shape, jnp.uint8, base.Direction.IN)
        elif template.use_flags == BackgroundFlags.CHANNEL:
            self.slots["flags"] = base.Slot((channels,), jnp.uint8, base.Direction.IN)

    def _run(self, vis, flags=None):
        deviations = background_median_filter(
            vis, flags, self.template.width, self.template.is_amplitude,
            self.template.use_flags, self.template.engine,
        )
        return {"deviations": deviations}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "width": self.template.width,
            "use_flags": self.template.use_flags.name,
            "channels": self.channels,
            "baselines": self.baselines,
        }


class NoiseEstMADTDeviceTemplate(AbstractNoiseEstDeviceTemplate):
    """Transposed-layout MAD noise estimator (reference rfi/device.py:363-614).

    The reference's transposed variant holds a whole baseline per workgroup
    (madnz_t.mako); here the rank search vectorizes across baselines, so
    `max_channels` only bounds the channel count (and sizes the tuning
    search).  The tuning knob is the rank
    search's ``radix_bits`` digit width (bits resolved per data sweep —
    every value is exact; see :func:`..ops.rank.find_rank_float`).
    """

    host_class = host.NoiseEstMADHost
    transposed = True
    autotune_version = 3

    def __init__(self, context, max_channels: int = 32768, tuning=None):
        self.context = context
        self.max_channels = max_channels
        if tuning is None:
            tuning = self.autotune(context, max_channels)
        self.radix_bits = tuning.get("radix_bits", 4)

    @classmethod
    @tune.autotuner(test={"radix_bits": 4})
    def autotune(cls, context, max_channels) -> Mapping[str, Any]:
        return _madnz_radix_search(axis=-1, channels=min(max_channels, 8192))

    def instantiate(self, command_queue=None, channels=0, baselines=0, allocator=None):
        if channels > self.max_channels:
            raise ValueError("channels exceeds max_channels")
        return NoiseEstMADTDevice(self, channels, baselines)


class NoiseEstMADTDevice(AbstractNoiseEstDevice):
    """.. rubric:: Slots

    **deviations** : (baselines, channels) float32 (transposed layout)
    **noise** : (baselines,) float32, output
    """

    transposed = True

    def __init__(self, template, channels, baselines):
        super().__init__()
        self.template = template
        self.channels = channels
        self.baselines = baselines
        self.slots["deviations"] = base.Slot((baselines, channels), jnp.float32, base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), jnp.float32, base.Direction.OUT)

    def _run(self, deviations):
        return {"noise": madnz(deviations, radix_bits=self.template.radix_bits)}

    def parameters(self) -> Mapping[str, Any]:
        return {"channels": self.channels, "baselines": self.baselines, "transposed": True}


def _madnz_radix_search(axis: int, channels: int, baselines: int = 128) -> Mapping[str, Any]:
    """Measured ``radix_bits`` search shared by the noise-estimate templates."""
    import functools

    rs = np.random.RandomState(2021)
    shape = (baselines, channels) if axis == -1 else (channels, baselines)
    dev = jnp.asarray(np.abs(rs.standard_normal(shape)).astype(np.float32))

    def generate(radix_bits):
        fn = jax.jit(functools.partial(madnz, axis=axis, radix_bits=radix_bits))
        jax.block_until_ready(fn(dev))
        return tune.make_measure(fn, dev)

    return tune.autotune(generate, radix_bits=[1, 2, 4, 8])


class NoiseEstMADDeviceTemplate(AbstractNoiseEstDeviceTemplate):
    """Straight-layout MAD noise estimator (reference rfi/device.py:363-470).

    Same arithmetic as the transposed variant; XLA folds the axis swap into
    the rank reductions, so no physical corner-turn happens.  Tuning knob:
    ``radix_bits`` (see :class:`NoiseEstMADTDeviceTemplate`).
    """

    host_class = host.NoiseEstMADHost
    transposed = False
    autotune_version = 3

    def __init__(self, context, tuning=None):
        self.context = context
        if tuning is None:
            tuning = self.autotune(context)
        self.radix_bits = tuning.get("radix_bits", 4)

    @classmethod
    @tune.autotuner(test={"radix_bits": 4})
    def autotune(cls, context) -> Mapping[str, Any]:
        return _madnz_radix_search(axis=0, channels=8192)

    def instantiate(self, command_queue=None, channels=0, baselines=0, allocator=None):
        return NoiseEstMADDevice(self, channels, baselines)


class NoiseEstMADDevice(AbstractNoiseEstDevice):
    """.. rubric:: Slots

    **deviations** : (channels, baselines) float32
    **noise** : (baselines,) float32, output
    """

    transposed = False

    def __init__(self, template, channels, baselines):
        super().__init__()
        self.template = template
        self.channels = channels
        self.baselines = baselines
        self.slots["deviations"] = base.Slot((channels, baselines), jnp.float32, base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), jnp.float32, base.Direction.OUT)

    def _run(self, deviations):
        return {"noise": madnz(deviations, axis=0, radix_bits=self.template.radix_bits)}

    def parameters(self) -> Mapping[str, Any]:
        return {"channels": self.channels, "baselines": self.baselines, "transposed": False}


class ThresholdSimpleDeviceTemplate(AbstractThresholdDeviceTemplate):
    """Elementwise threshold (reference rfi/device.py:654-809).

    One fused elementwise compare — no searchable dimension exists (the reference
    tunes work-group sides, rfi/device.py:700-720), so this template has
    no autotune and ``tuning`` is accepted for signature parity and
    ignored.
    """

    host_class = host.ThresholdSimpleHost

    def __init__(self, context, transposed: bool = False, flag_value: int = 1, tuning=None):
        self.context = context
        self.transposed = transposed
        self.flag_value = flag_value

    def instantiate(self, command_queue=None, channels=0, baselines=0, n_sigma=11.0, *, allocator=None):
        return ThresholdSimpleDevice(self, channels, baselines, n_sigma)


class ThresholdSimpleDevice(AbstractThresholdDevice):
    """.. rubric:: Slots

    **deviations** : (channels, baselines) float32 — or (baselines, channels) if transposed
    **noise** : (baselines,) float32
    **flags** : same shape as deviations, uint8, output
    """

    def __init__(self, template, channels, baselines, n_sigma):
        super().__init__()
        self.template = template
        self.transposed = template.transposed
        self.channels = channels
        self.baselines = baselines
        self.n_sigma = n_sigma
        shape = (baselines, channels) if template.transposed else (channels, baselines)
        self.slots["deviations"] = base.Slot(shape, jnp.float32, base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), jnp.float32, base.Direction.IN)
        self.slots["flags"] = base.Slot(shape, jnp.uint8, base.Direction.OUT)

    def _run(self, deviations, noise):
        flags = threshold_simple(
            deviations, noise, self.n_sigma, self.template.flag_value, self.transposed
        )
        return {"flags": flags}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "n_sigma": self.n_sigma,
            "flag_value": self.template.flag_value,
            "transposed": self.transposed,
        }


class ThresholdSumDeviceTemplate(AbstractThresholdDeviceTemplate):
    """SumThreshold on transposed data (reference rfi/device.py:812-995).

    Parameters
    ----------
    n_windows
        Number of power-of-two window sizes.
    threshold_falloff
        ρ in Offringa (2010); per-window thresholds are
        ``n_sigma * rho**-i`` (reference rfi/device.py:957-959).
    tuning
        Accepted for signature parity and ignored: the shifted-add window
        sums are pinned by oracle float parity (cumsum differences
        reassociate), and the reference's ``wgs``/``vt`` knobs
        (rfi/device.py:867-887) have no XLA analogue.
    """

    host_class = host.ThresholdSumHost
    transposed = True

    def __init__(self, context, n_windows: int = 4, threshold_falloff: float = 1.2,
                 flag_value: int = 1, tuning=None):
        self.context = context
        self.n_windows = n_windows
        self.threshold_falloff = threshold_falloff
        self.flag_value = flag_value

    def instantiate(self, command_queue=None, channels=0, baselines=0, n_sigma=11.0, *, allocator=None):
        return ThresholdSumDevice(self, channels, baselines, n_sigma)


class ThresholdSumDevice(AbstractThresholdDevice):
    """.. rubric:: Slots

    **deviations** : (baselines, channels) float32 (transposed layout)
    **noise** : (baselines,) float32
    **flags** : (baselines, channels) uint8, output
    """

    transposed = True

    def __init__(self, template, channels, baselines, n_sigma):
        super().__init__()
        self.template = template
        self.channels = channels
        self.baselines = baselines
        self.n_sigma = n_sigma
        shape = (baselines, channels)
        self.slots["deviations"] = base.Slot(shape, jnp.float32, base.Direction.IN)
        self.slots["noise"] = base.Slot((baselines,), jnp.float32, base.Direction.IN)
        self.slots["flags"] = base.Slot(shape, jnp.uint8, base.Direction.OUT)

    def _run(self, deviations, noise):
        flags = threshold_sum(
            deviations,
            noise,
            self.n_sigma,
            self.template.n_windows,
            self.template.threshold_falloff,
            self.template.flag_value,
        )
        return {"flags": flags}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "n_sigma": self.n_sigma,
            "n_windows": self.template.n_windows,
            "threshold_falloff": self.template.threshold_falloff,
            "flag_value": self.template.flag_value,
        }


# ---------------------------------------------------------------------------
# Layout-change helper ops
# ---------------------------------------------------------------------------


class _TransposeOp(base.Operation):
    """Internal corner-turn between straight and transposed stages."""

    def __init__(self, shape, dtype):
        super().__init__()
        self.slots["src"] = base.Slot(shape, dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[1], shape[0]), dtype, base.Direction.OUT)

    def _run(self, src):
        return {"dest": transpose_ops.transpose(src)}


# ---------------------------------------------------------------------------
# Composed flagger
# ---------------------------------------------------------------------------


class FlaggerDeviceTemplate:
    """Compose background, noise estimation and thresholding stages.

    Reference: rfi/device.py:998-1107.  Transposes are inserted
    automatically when the stage ``transposed`` attributes demand
    (rfi/device.py:1026-1037); under one jit they are layout directives to
    XLA rather than materialized corner-turns.
    """

    def __init__(
        self,
        background: BackgroundMedianFilterDeviceTemplate,
        noise_est: AbstractNoiseEstDeviceTemplate,
        threshold: AbstractThresholdDeviceTemplate,
    ):
        self.background = background
        self.noise_est = noise_est
        self.threshold = threshold

    def instantiate(
        self,
        command_queue=None,
        channels: int = 0,
        baselines: int = 0,
        background_args: Mapping[str, Any] = {},
        noise_est_args: Mapping[str, Any] = {},
        threshold_args: Mapping[str, Any] = {},
        allocator=None,
    ):
        return FlaggerDevice(
            self, channels, baselines, background_args, noise_est_args, threshold_args
        )


class FlaggerDevice(base.OperationSequence):
    """Concrete composed flagger (reference rfi/device.py:1039-1166).

    .. rubric:: Slots

    **vis** : (channels, baselines) — input visibilities
    **input_flags** : input flags (only when background uses flags)
    **flags** : (channels, baselines) uint8 — output flags
    """

    def __init__(self, template, channels, baselines, background_args={},
                 noise_est_args={}, threshold_args={}):
        self.template = template
        self.channels = channels
        self.baselines = baselines

        background = template.background.instantiate(
            None, channels, baselines, **dict(background_args)
        )
        noise_est = template.noise_est.instantiate(None, channels, baselines, **dict(noise_est_args))
        threshold = template.threshold.instantiate(None, channels, baselines, **dict(threshold_args))

        noise_t = getattr(noise_est, "transposed", template.noise_est.transposed)
        thresh_t = getattr(threshold, "transposed", template.threshold.transposed)

        operations = [("background", background)]
        compounds = {"vis": ["background:vis"], "deviations": ["background:deviations"]}
        if template.background.use_flags:
            compounds["input_flags"] = ["background:flags"]

        need_dev_t = noise_t or thresh_t
        if need_dev_t:
            operations.append(
                ("transpose_deviations", _TransposeOp((channels, baselines), jnp.float32))
            )
            compounds["deviations"].append("transpose_deviations:src")
            compounds["deviations_t"] = ["transpose_deviations:dest"]

        operations.append(("noise_est", noise_est))
        dev_name = "deviations_t" if noise_t else "deviations"
        compounds[dev_name] = compounds.get(dev_name, []) + ["noise_est:deviations"]
        compounds["noise"] = ["noise_est:noise"]

        operations.append(("threshold", threshold))
        dev_name = "deviations_t" if thresh_t else "deviations"
        compounds[dev_name] = compounds.get(dev_name, []) + ["threshold:deviations"]
        compounds["noise"].append("threshold:noise")

        if thresh_t:
            compounds["flags_t"] = ["threshold:flags"]
            operations.append(("transpose_flags", _TransposeOp((baselines, channels), jnp.uint8)))
            compounds["flags_t"].append("transpose_flags:src")
            compounds["flags"] = ["transpose_flags:dest"]
        else:
            compounds["flags"] = ["threshold:flags"]

        super().__init__(operations, compounds)

    def parameters(self) -> Mapping[str, Any]:
        return {
            "channels": self.channels,
            "baselines": self.baselines,
            **{f"{name}:{k}": v for name, op in self.operations
               for k, v in op.parameters().items()},
        }


# ---------------------------------------------------------------------------
# Host-interface wrappers (the oracle adapters used by the parity tests)
# ---------------------------------------------------------------------------


class BackgroundHostFromDevice(host.AbstractBackgroundHost):
    """Present the host API over a device background template
    (reference rfi/device.py:113-138)."""

    def __init__(self, template: AbstractBackgroundDeviceTemplate, command_queue=None):
        self.template = template
        self.command_queue = command_queue

    def __call__(self, vis: np.ndarray, flags: Optional[np.ndarray] = None) -> np.ndarray:
        if flags is not None and not self.template.use_flags:
            raise TypeError("flags were provided but not included in the template")
        if flags is None and self.template.use_flags:
            raise TypeError("flags were expected but not provided")
        channels, baselines = vis.shape
        fn = self.template.instantiate(self.command_queue, channels, baselines)
        inputs = {"vis": jnp.asarray(fn.slots["vis"].dtype.type(vis))}
        if flags is not None:
            inputs["flags"] = jnp.asarray(flags.astype(np.uint8))
        return np.asarray(fn(**inputs)["deviations"])


class NoiseEstHostFromDevice(host.AbstractNoiseEstHost):
    """Reference rfi/device.py:336-360."""

    def __init__(self, template: AbstractNoiseEstDeviceTemplate, command_queue=None):
        self.template = template

    def __call__(self, deviations: np.ndarray) -> np.ndarray:
        channels, baselines = deviations.shape
        fn = self.template.instantiate(None, channels, baselines)
        dev = deviations.astype(np.float32)
        if self.template.transposed:
            dev = dev.T
        return np.asarray(fn(deviations=jnp.asarray(dev))["noise"])


class ThresholdHostFromDevice(host.AbstractThresholdHost):
    """Reference rfi/device.py:617-651."""

    def __init__(self, template: AbstractThresholdDeviceTemplate, command_queue=None, **kwargs):
        self.template = template
        self.kwargs = kwargs

    def __call__(self, deviations: np.ndarray, noise: np.ndarray) -> np.ndarray:
        channels, baselines = deviations.shape
        fn = self.template.instantiate(None, channels, baselines, **self.kwargs)
        dev = deviations.astype(np.float32)
        if self.template.transposed:
            dev = dev.T
        out = np.asarray(
            fn(deviations=jnp.asarray(dev), noise=jnp.asarray(noise.astype(np.float32)))["flags"]
        )
        if self.template.transposed:
            out = out.T
        return out


class FlaggerHostFromDevice(host.AbstractFlaggerHost):
    """Reference rfi/device.py:1169-1222."""

    def __init__(self, template: FlaggerDeviceTemplate, command_queue=None,
                 background_args: Mapping[str, Any] = {}, noise_est_args: Mapping[str, Any] = {},
                 threshold_args: Mapping[str, Any] = {}):
        self.template = template
        self.background_args = dict(background_args)
        self.noise_est_args = dict(noise_est_args)
        self.threshold_args = dict(threshold_args)

    def __call__(self, vis: np.ndarray, input_flags: Optional[np.ndarray] = None) -> np.ndarray:
        channels, baselines = vis.shape
        fn = self.template.instantiate(
            None, channels, baselines,
            self.background_args, self.noise_est_args, self.threshold_args,
        )
        inputs = {"vis": jnp.asarray(fn.slots["vis"].dtype.type(vis))}
        if input_flags is not None:
            inputs["input_flags"] = jnp.asarray(input_flags.astype(np.uint8))
        return np.asarray(fn(**inputs)["flags"])
