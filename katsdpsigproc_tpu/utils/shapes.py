"""Shape, padding, and tiling contracts.

The reference propagates per-axis padding/alignment requirements through a
union-find ``Dimension`` system so that composed kernels agree on buffer
strides (reference: src/katsdpsigproc/accel.py:1115-1294).  Under XLA most of
that is subsumed by the compiler's layout assignment; what remains is an
explicit, queryable contract for

* rounding sizes up to tile multiples (128 along the last axis; the
  second-to-last axis by itemsize), and
* padding arrays so blocked kernels divide evenly, with a defined pad
  value (the reference declares padding contents "undefined",
  doc/user/buffers.rst:26-31; we make the pad value explicit per op so that
  reductions and rank statistics can ignore it).
"""

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

#: Last-axis tile multiple for every dtype.
LANES = 128

#: Second-to-last-axis tile multiple by itemsize (float32 → 8,
#: bfloat16 → 16, int8/fp8 → 32).
_SUBLANES_BY_ITEMSIZE = {8: 4, 4: 8, 2: 16, 1: 32}


def sublanes(dtype) -> int:
    """Minimum second-to-last-axis tile for ``dtype``."""
    return _SUBLANES_BY_ITEMSIZE.get(np.dtype(dtype).itemsize, 8)


def divup(x: int, y: int) -> int:
    """Ceiling division (reference: accel.py `divup`)."""
    return (x + y - 1) // y


def roundup(x: int, y: int) -> int:
    """Round `x` up to a multiple of `y` (reference: accel.py `roundup`)."""
    return divup(x, y) * y


def padded_shape(shape: Sequence[int], dtype=jnp.float32) -> Tuple[int, ...]:
    """Round the trailing two axes of `shape` up to the tile grid."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return shape
    if len(shape) == 1:
        return (roundup(shape[0], LANES),)
    return shape[:-2] + (roundup(shape[-2], sublanes(dtype)), roundup(shape[-1], LANES))


def pad_to(
    x: jnp.ndarray,
    shape: Sequence[int],
    pad_value=0,
) -> jnp.ndarray:
    """Pad `x` at the end of each axis up to `shape` with `pad_value`."""
    pads = [(0, int(t) - int(s)) for s, t in zip(x.shape, shape)]
    if all(p == (0, 0) for p in pads):
        return x
    return jnp.pad(x, pads, constant_values=pad_value)


def pad_tiles(x: jnp.ndarray, pad_value=0, shape: Optional[Sequence[int]] = None) -> jnp.ndarray:
    """Pad `x` so its trailing axes are tile-aligned (or to an explicit shape)."""
    target = padded_shape(x.shape, x.dtype) if shape is None else tuple(shape)
    return pad_to(x, target, pad_value)


def crop_to(x: jnp.ndarray, shape: Sequence[int]) -> jnp.ndarray:
    """Slice the leading corner of `x` down to `shape` (inverse of `pad_to`)."""
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, int(s)) for s in shape)]
