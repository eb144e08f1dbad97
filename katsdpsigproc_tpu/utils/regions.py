"""Region copies with numpy-index syntax (functional form).

Reference: src/katsdpsigproc/accel.py:588-920 — ``DeviceArray.copy_region``
/ ``get_region`` / ``set_region`` perform rectangular sub-region transfers
described by ``np.s_`` index expressions, validating that both regions
select the same shape and dtype.

Design: ``jax.Array`` is immutable and transfers are managed by
the runtime, so the API is functional — device-to-device and
host-to-device copies return a NEW destination array (an eager
``.at[...].set`` update, i.e. O(destination) per call; wrap the call in a
jit with buffer donation if copies sit in a loop), and device-to-host
copies slice ON DEVICE first so only the region travels over the wire.
The index-expression dialect and the error contract are the reference's:

- slices with positive strides (length ``(stop - start) // stride``,
  the reference's truncating formula, accel.py:633-636 — note this drops
  a ragged final element that numpy would include);
- integers (the axis is collapsed), negative values wrap;
- ``np.newaxis`` (inserts a length-1 axis into the selection);
- fewer indices than axes selects whole trailing axes;
- ``TypeError`` for dtype mismatch / invalid index types, ``ValueError``
  for shape mismatch between the two regions, ``IndexError`` for
  out-of-range, empty, or negative-stride selections.
"""

from typing import Any, Tuple

import numpy as np

__all__ = ["canonical_region", "copy_region", "copy_region_donated",
           "get_region", "set_region"]

_Slice = Any  # int | slice | newaxis | tuple of same (np.s_ expression)


def canonical_region(region: _Slice, shape: Tuple[int, ...]):
    """Validate `region` against `shape` (reference accel.py:588-654).

    Returns ``(index, sel_shape)``: `index` is a tuple of ints/slices that
    selects the region with basic indexing (newaxis entries removed), and
    `sel_shape` is the shape of the selection (including the length-1
    axes that newaxis inserts).
    """
    if not isinstance(region, tuple):
        region = (region,)
    index = []
    sel_shape = []
    axis = 0
    for ix in region:
        if ix is np.newaxis:
            sel_shape.append(1)
        elif isinstance(ix, slice):
            if axis >= len(shape):
                raise IndexError("Too many axes in index expression")
            start, stop, stride = ix.indices(shape[axis])
            if stride <= 0:
                raise IndexError("Only positive strides are supported")
            length = (stop - start) // stride
            if length <= 0:
                raise IndexError("Empty slice selection")
            index.append(slice(start, start + length * stride, stride))
            sel_shape.append(length)
            axis += 1
        elif isinstance(ix, (int, np.integer)) and not isinstance(ix, bool):
            if axis >= len(shape):
                raise IndexError("Too many axes in index expression")
            ix = int(ix)
            if ix < 0:
                ix += shape[axis]
            if not 0 <= ix < shape[axis]:
                raise IndexError("Index out of range")
            index.append(ix)
            axis += 1
        else:
            raise TypeError(f"Invalid type in slice: {type(ix)}")
    while axis < len(shape):
        index.append(slice(0, shape[axis], 1))
        sel_shape.append(shape[axis])
        axis += 1
    return tuple(index), tuple(sel_shape)


def _check_pair(src, dest, src_region, dest_region):
    if src.dtype != dest.dtype:
        raise TypeError(f"dtype mismatch: {src.dtype} vs {dest.dtype}")
    src_index, src_sel = canonical_region(src_region, src.shape)
    dest_index, dest_sel = canonical_region(dest_region, dest.shape)
    if src_sel != dest_sel:
        raise ValueError(f"Source ({src_sel}) and destination ({dest_sel}) "
                         "regions select different shapes")
    return src_index, src_sel, dest_index, dest_sel


def copy_region(src, dest, src_region: _Slice, dest_region: _Slice):
    """Device-to-device region copy; returns the new destination array.

    Functional analogue of ``DeviceArray.copy_region``
    (reference accel.py:757-811): ``dest.at[dest_region].set(src[src_region])``
    with the reference's validation.
    """
    import jax.numpy as jnp

    src = jnp.asarray(src)
    dest = jnp.asarray(dest)
    src_index, _, dest_index, _ = _check_pair(src, dest, src_region, dest_region)
    values = src[src_index]
    # Both selections have equal shape up to newaxis-inserted 1s; align the
    # copied values to the destination's basic-index shape.
    return dest.at[dest_index].set(values.reshape(_basic_shape(dest_index, dest.shape)))


_DONATED_CACHE: dict = {}


def copy_region_donated(src, dest, src_region: _Slice, dest_region: _Slice):
    """:func:`copy_region` through a cached jit with `dest` DONATED.

    ``copy_region`` is an eager ``.at[].set`` — O(destination) work and a
    fresh allocation per call.  This variant compiles one program per
    (shapes, dtype, regions) signature with the destination buffer
    donated, so in steady state XLA updates the region in place: the
    right form when region copies sit in a loop.  The donated `dest`
    array is CONSUMED — use the returned array afterwards.
    """
    import jax
    import jax.numpy as jnp

    src = jnp.asarray(src)
    dest = jnp.asarray(dest)
    src_index, _, dest_index, _ = _check_pair(src, dest, src_region, dest_region)
    key = (
        src.shape, dest.shape, str(src.dtype),
        tuple((s.start, s.stop, s.step) if isinstance(s, slice) else s
              for s in src_index),
        tuple((s.start, s.stop, s.step) if isinstance(s, slice) else s
              for s in dest_index),
    )
    fn = _DONATED_CACHE.get(key)
    if fn is None:
        shape = _basic_shape(dest_index, dest.shape)

        def impl(s, d):
            return d.at[dest_index].set(s[src_index].reshape(shape))

        fn = jax.jit(impl, donate_argnums=(1,))
        _DONATED_CACHE[key] = fn
    return fn(src, dest)


def get_region(src, ary: np.ndarray, device_region: _Slice, ary_region: _Slice) -> None:
    """Device-to-host region copy into `ary` (in place).

    Functional analogue of ``DeviceArray.get_region``
    (reference accel.py:813-866): the region is sliced ON DEVICE and only
    that sub-array is fetched.  Host-side placement uses the same
    canonicalized selection, so the two regions are validated to match.
    """
    import jax.numpy as jnp

    src = jnp.asarray(src)
    src_index, _, ary_index, _ = _check_pair(src, ary, device_region, ary_region)
    ary[ary_index] = np.asarray(src[src_index]).reshape(_basic_shape(ary_index, ary.shape))


def set_region(dest, ary: np.ndarray, device_region: _Slice, ary_region: _Slice):
    """Host-to-device region copy; returns the new destination array.

    Functional analogue of ``DeviceArray.set_region``
    (reference accel.py:868-920).
    """
    import jax.numpy as jnp

    dest = jnp.asarray(dest)
    ary = np.asarray(ary)
    ary_index, _, dest_index, _ = _check_pair(ary, dest, ary_region, device_region)
    values = ary[ary_index].reshape(_basic_shape(dest_index, dest.shape))
    return dest.at[dest_index].set(values)


def _basic_shape(index, shape):
    """Shape produced by applying basic `index` (no newaxis) to `shape`."""
    out = []
    axis = 0
    for ix in index:
        if isinstance(ix, slice):
            start, stop, stride = ix.start, ix.stop, ix.step
            out.append(max(0, (stop - start + stride - 1) // stride))
            axis += 1
        else:
            axis += 1  # int collapses
    out.extend(shape[axis:])
    return tuple(out)
