"""Multi-device RFI flagger: baseline/channel sharding with collectives.

This is the capability the reference does not have (SURVEY.md §2.5): the
flagger pipeline runs under ``shard_map`` over a 2-D
``(baseline, channel)`` mesh:

* **Baseline sharding** (the production MeerKAT layout, BASELINE.json):
  embarrassingly parallel — each device flags its own baselines over the
  full band; no communication at all.
* **Channel sharding** (the sequence-parallel analogue for very long
  spectra): three communication patterns, all exact:

  - background median filter: ``width//2``-channel halo exchange
    (``ppermute``) before the windowed median;
  - MAD noise estimate: the bitwise rank search with psummed counts
    (:func:`katsdpsigproc_tpu.parallel.collectives.median_non_zero`) — the
    reference's rank.mako:197-208 search distributed without gathering;
  - SumThreshold: ``EDGE_SIZE = 2**w - w - 1`` halo (exactly the
    reference's chunk-overlap bound, threshold_sum.mako:38-40) and a local
    run over the extended block, cropping the interior.

The per-shard math reuses the single-device functional kernels from
:mod:`katsdpsigproc_tpu.models.rfi.device`, so device↔host parity carries
over shard-for-shard.
"""

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from jax.sharding import PartitionSpec as P

from ..models.rfi import MAD_NORMAL, device as rfi_device
from ..ops import rank as rank_ops
from . import collectives
from .mesh import BASELINE_AXIS, CHANNEL_AXIS


def make_sharded_flagger(
    mesh,
    width: int = 13,
    n_sigma: float = 11.0,
    is_amplitude: bool = False,
    use_flags: rfi_device.BackgroundFlags = rfi_device.BackgroundFlags.NONE,
    threshold: str = "sum",
    n_windows: int = 4,
    threshold_falloff: float = 1.2,
    flag_value: int = 1,
    baseline_block: Optional[int] = None,
):
    """Build a jitted multi-device flagger over `mesh`.

    The mesh must name the ``baseline`` axis and may name a ``channel``
    axis (size 1 reduces to pure baseline sharding).  Returns a function
    ``flags = fn(vis[, input_flags])`` on (channels, baselines) arrays whose
    shapes divide the mesh axes.

    ``baseline_block`` processes each shard's local baselines in
    sequential blocks (``lax.scan``) to bound the working set.
    Collectives run once per block — every device scans the same number
    of blocks, so the psum/ppermute schedules stay aligned.  Ignored
    unless it divides the local baseline count.
    """
    if BASELINE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh must name a {BASELINE_AXIS!r} axis")
    has_channel = CHANNEL_AXIS in mesh.axis_names
    h = width // 2
    edge = (1 << n_windows) - n_windows - 1  # reference EDGE_SIZE

    c_axis = CHANNEL_AXIS if has_channel else None
    if use_flags == rfi_device.BackgroundFlags.CHANNEL:
        flag_spec: Optional[P] = P(c_axis)
    elif use_flags == rfi_device.BackgroundFlags.FULL:
        flag_spec = P(c_axis, BASELINE_AXIS)
    else:
        flag_spec = None

    def local_flag(n_channels_global: int, vis, input_flags=None):
        # ---- background (halo = width//2 channels) -----------------------
        if is_amplitude:
            amp = vis.astype(jnp.float32)
            invalid = amp < 0
        else:
            # complex64 or planar (C, B, 2) float32
            amp = rfi_device.amplitude(vis)
            invalid = jnp.zeros(amp.shape, bool)
        if use_flags == rfi_device.BackgroundFlags.CHANNEL:
            invalid = invalid | (input_flags != 0)[:, None]
        elif use_flags == rfi_device.BackgroundFlags.FULL:
            invalid = invalid | (input_flags != 0)
        amp = jnp.where(invalid, jnp.nan, amp)
        c_local = amp.shape[0]
        if has_channel:
            amp_ext = collectives.halo_exchange(amp, h, CHANNEL_AXIS, jnp.nan, axis=0)
        else:
            amp_ext = jnp.pad(amp, ((h, h), (0, 0)), constant_values=jnp.nan)

        def flag_block(amp_ext_blk):
            """Background → noise → threshold on one (C_ext, b) block;
            returns (b, C_local) transposed flags."""
            # The filter re-pads internally; feed it the extended block
            # and keep the interior rows, which only ever see real
            # neighbour data.
            med_ext, _ = rfi_device.masked_median_filter(amp_ext_blk, width)
            med = med_ext[h : h + c_local]
            deviations = amp_ext_blk[h : h + c_local] - med
            deviations = jnp.where(jnp.isnan(deviations), 0.0, deviations).astype(jnp.float32)

            # ---- noise (collective rank search over the channel axis) ----
            dev_t = jnp.swapaxes(deviations, 0, 1)  # (b, C_local)
            values = jnp.abs(dev_t)
            if has_channel:
                noise = (
                    MAD_NORMAL
                    * collectives.median_non_zero(values, n_channels_global, CHANNEL_AXIS)
                ).astype(jnp.float32)
            else:
                noise = (
                    MAD_NORMAL * rank_ops.median_non_zero(values, n_channels_global)
                ).astype(jnp.float32)

            # ---- threshold -----------------------------------------------
            if threshold == "simple":
                return rfi_device.threshold_simple(dev_t, noise, n_sigma, flag_value, True)
            if has_channel:
                dev_t_ext = collectives.halo_exchange(dev_t, edge, CHANNEL_AXIS, 0.0, axis=1)
                flags_ext = rfi_device.threshold_sum(
                    dev_t_ext, noise, n_sigma, n_windows, threshold_falloff, flag_value
                )
                return flags_ext[:, edge : edge + dev_t.shape[1]] if edge else flags_ext
            return rfi_device.threshold_sum(
                dev_t, noise, n_sigma, n_windows, threshold_falloff, flag_value
            )

        b_local = amp.shape[1]
        if baseline_block and b_local % baseline_block == 0 and b_local > baseline_block:
            nb = b_local // baseline_block
            blocks = jnp.moveaxis(
                amp_ext.reshape(amp_ext.shape[0], nb, baseline_block), 1, 0
            )
            _, flags_blocks = jax.lax.scan(
                lambda carry, blk: (carry, flag_block(blk)), None, blocks
            )
            flags_t = flags_blocks.reshape(b_local, c_local)
        else:
            flags_t = flag_block(amp_ext)
        return jnp.swapaxes(flags_t, 0, 1)

    def build(n_channels_global, planar: bool):
        vis_spec = P(c_axis, BASELINE_AXIS, None) if planar else P(c_axis, BASELINE_AXIS)
        in_specs = [vis_spec] + ([flag_spec] if flag_spec is not None else [])
        fn = jax.shard_map(
            functools.partial(local_flag, n_channels_global),
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=P(c_axis, BASELINE_AXIS),
            check_vma=False,
        )
        return jax.jit(fn)

    cache = {}

    def flagger(vis, input_flags=None):
        planar = not is_amplitude and vis.ndim == 3
        key = (vis.shape[0], planar)
        if key not in cache:
            cache[key] = build(vis.shape[0], planar)
        if flag_spec is not None:
            if input_flags is None:
                raise TypeError("flags were expected but not provided")
            return cache[key](vis, input_flags)
        if input_flags is not None:
            raise TypeError("flags were provided but not included in the template")
        return cache[key](vis)

    return flagger
