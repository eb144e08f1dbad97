"""Batched N-D FFT operation.

Reference: src/katsdpsigproc/fft.py:205-423 — a ctypes binding to cuFFT
with R2C/C2R/C2C (and double-precision) batched plans over padded
embeddings, unnormalised transforms, an explicit work-area slot, and a
plan lock for stream mutation.

Design: XLA provides the FFT (cuFFT on a GPU) (``jnp.fft``), so the template
carries only shape/dtype contracts.  cuFFT's unnormalised-inverse
convention is preserved (forward∘inverse scales by the transform size —
reference fft.py:228-230), which means the inverse multiplies XLA's
normalised IFFT back up.  Work-area aliasing and plan locks have no
analogue (XLA owns scratch and the runtime is thread-safe by
construction — SURVEY.md §7 "cuFFT ctypes wrapper → jnp.fft").

Note: double-precision transforms (the reference's D2Z/Z2D/Z2Z) are
accepted but require JAX's x64 mode.
"""

import enum
from typing import Any, Mapping, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from . import base


class FftMode(enum.Enum):
    """Direction of the transform (reference fft.py:47-56)."""

    FORWARD = enum.auto()
    INVERSE = enum.auto()


_VALID_COMBOS = {
    (np.dtype(np.float32), np.dtype(np.complex64)): "r2c",
    (np.dtype(np.complex64), np.dtype(np.float32)): "c2r",
    (np.dtype(np.complex64), np.dtype(np.complex64)): "c2c",
    (np.dtype(np.float64), np.dtype(np.complex128)): "r2c",
    (np.dtype(np.complex128), np.dtype(np.float64)): "c2r",
    (np.dtype(np.complex128), np.dtype(np.complex128)): "c2c",
}


class FftTemplate:
    r"""Operation template for a forward or reverse FFT.

    The transformation is done over the last N dimensions, with the
    remaining dimensions for batching multiple arrays to be transformed.
    The template can specify real->complex, complex->real, or
    complex->complex; in the last case the same template instantiates
    forward or inverse transforms (reference fft.py:205-247).

    For real<->complex transforms, the final dimension of the complex side
    is :math:`\lfloor L/2\rfloor + 1` where :math:`L` is the last element
    of `shape`.

    The transform is unnormalised: a forward followed by a reverse
    transform scales the result by the number of transformed elements.

    Parameters
    ----------
    context
        Placement context.
    N
        Number of dimensions for the transform.
    shape
        Shape of the data (N or more dimensions); for real<->complex, the
        shape of the real side.
    dtype_src, dtype_dest
        Input/output dtypes; the pair selects R2C/C2R/C2C.
    padded_shape_src, padded_shape_dest
        Accepted for API parity (XLA owns layout); batch dims must be
        unpadded, as in the reference (fft.py:262-266).
    """

    def __init__(self, context, N: int, shape: Tuple[int, ...], dtype_src, dtype_dest,
                 padded_shape_src: Optional[Tuple[int, ...]] = None,
                 padded_shape_dest: Optional[Tuple[int, ...]] = None, tuning=None) -> None:
        dtype_src = np.dtype(dtype_src)
        dtype_dest = np.dtype(dtype_dest)
        kind = _VALID_COMBOS.get((dtype_src, dtype_dest))
        if kind is None:
            raise ValueError("Invalid combination of dtypes")
        if padded_shape_src is not None and len(padded_shape_src) != len(shape):
            raise ValueError("padded_shape_src and shape must have same length")
        if padded_shape_dest is not None and len(padded_shape_dest) != len(shape):
            raise ValueError("padded_shape_dest and shape must have same length")
        if padded_shape_src is not None and tuple(padded_shape_src[:-N]) != tuple(shape[:-N]):
            raise ValueError("Source must not be padded on batch dimensions")
        if padded_shape_dest is not None and tuple(padded_shape_dest[:-N]) != tuple(shape[:-N]):
            raise ValueError("Destination must not be padded on batch dimensions")
        self.context = context
        self.N = N
        self.shape = tuple(shape)
        self.kind = kind
        # Recorded for API parity (reference fft.py:262-266); under XLA the
        # padded embedding is a layout concern the compiler owns.
        self.padded_shape_src = None if padded_shape_src is None else tuple(padded_shape_src)
        self.padded_shape_dest = None if padded_shape_dest is None else tuple(padded_shape_dest)
        self.dtype_src = dtype_src
        self.dtype_dest = dtype_dest
        if kind == "r2c":
            self.shape_src = self.shape
            self.shape_dest = self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        elif kind == "c2r":
            self.shape_src = self.shape[:-1] + (self.shape[-1] // 2 + 1,)
            self.shape_dest = self.shape
        else:
            self.shape_src = self.shape
            self.shape_dest = self.shape

    def instantiate(self, command_queue=None, mode: FftMode = FftMode.FORWARD, allocator=None):
        return Fft(self, mode)


class Fft(base.Operation):
    """Concrete FFT operation (reference fft.py:342-423).

    .. rubric:: Slots

    **src** : input array
    **dest** : output array

    R2C transforms must use ``FftMode.FORWARD`` and C2R transforms
    ``FftMode.INVERSE`` (reference fft.py:385-390).
    """

    def __init__(self, template: FftTemplate, mode: FftMode) -> None:
        super().__init__()
        self.template = template
        if template.kind == "r2c" and mode != FftMode.FORWARD:
            raise ValueError("R2C transform must use FftMode.FORWARD")
        if template.kind == "c2r" and mode != FftMode.INVERSE:
            raise ValueError("C2R transform must use FftMode.INVERSE")
        self.mode = mode
        self.slots["src"] = base.Slot(template.shape_src, template.dtype_src, base.Direction.IN)
        self.slots["dest"] = base.Slot(template.shape_dest, template.dtype_dest, base.Direction.OUT)

    def _run(self, src):
        n = self.template.N
        axes = tuple(range(src.ndim - n, src.ndim))
        lengths = self.template.shape[-n:]
        scale = float(np.prod(lengths))
        if self.template.kind == "r2c":
            out = jnp.fft.rfftn(src, axes=axes)
        elif self.template.kind == "c2r":
            # cuFFT C2R is unnormalised; XLA's irfftn divides by prod(lengths).
            out = jnp.fft.irfftn(src, s=lengths, axes=axes) * scale
        elif self.mode == FftMode.FORWARD:
            out = jnp.fft.fftn(src, axes=axes)
        else:
            out = jnp.fft.ifftn(src, axes=axes) * scale
        return {"dest": out.astype(self.template.dtype_dest)}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "shape": self.template.shape,
            "N": self.template.N,
            "kind": self.template.kind,
            "mode": self.mode.name,
        }
