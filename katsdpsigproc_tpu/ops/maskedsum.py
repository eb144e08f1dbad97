"""Masked column sum: per-column sum of rows weighted by a per-row mask.

Reference: src/katsdpsigproc/maskedsum.py:33-162 and maskedsum.mako:38-68 —
each output column is ``sum_r mask[r] * src[r, c]`` (complex64 input,
float32 mask), optionally over amplitudes (``|src[r, c]|``).

Design: this is a **vector–matrix product**, so instead of the
reference's per-column FMA loop it is expressed as ``mask @ src`` and left
to XLA's dot emitter.  Complex data decomposes into two real matvecs (XLA
does this automatically for complex64 dot); the amplitude variant is
|src| (fused into the read) followed by the same matvec.  Every dot asks
for ``Precision.HIGHEST``: a GPU may otherwise run a float32 product in
TF32 (about three decimal digits), while the reference sums in float32
FMA.  No tuning dimension survives — the product's tiling is XLA's job —
so this template has **no autotune** (the reference tunes a work-group
``size``, maskedsum.py:63-87) and ``tuning`` is accepted for signature
parity and ignored.
"""

from typing import Any, Mapping, Tuple

import jax.numpy as jnp
from jax import lax

_HIGHEST = lax.Precision.HIGHEST

from . import base


class MaskedSumTemplate:
    """Kernel for computing masked sums of a 2D array of data.

    Parameters
    ----------
    context
        Placement context.
    use_amplitudes
        If true, the amplitudes of the inputs rather than the inputs
        themselves will be summed.
    tuning
        Accepted for signature parity and ignored (no search dimension).
    """

    def __init__(self, context, use_amplitudes: bool = False, tuning=None) -> None:
        self.context = context
        self.use_amplitudes = use_amplitudes

    def instantiate(self, command_queue=None, shape: Tuple[int, int] = (0, 0), allocator=None):
        return MaskedSum(self, shape)


class MaskedSum(base.Operation):
    """Concrete instance of :class:`MaskedSumTemplate`.

    .. rubric:: Slots

    **src** : (rows, cols) complex64 input
    **mask** : (rows,) float32 mask
    **dest** : (cols,) complex64 — or float32 when ``use_amplitudes``
    """

    def __init__(self, template: MaskedSumTemplate, shape: Tuple[int, int]) -> None:
        super().__init__()
        self.template = template
        self.shape = tuple(shape)
        out_dtype = jnp.float32 if template.use_amplitudes else jnp.complex64
        self.slots["src"] = base.Slot(shape, jnp.complex64, base.Direction.IN)
        self.slots["mask"] = base.Slot((shape[0],), jnp.float32, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[1],), out_dtype, base.Direction.OUT)

    def _run(self, src, mask):
        return {"dest": maskedsum(src, mask, self.template.use_amplitudes)}

    def parameters(self) -> Mapping[str, Any]:
        return {"shape": self.shape, "use_amplitudes": self.template.use_amplitudes}


def maskedsum(src, mask, use_amplitudes: bool = False):
    """Functional masked column sum (a matvec at full float32 precision).

    `src` may be complex64 (rows, cols) or planar (rows, cols, 2) float32.
    Planar non-amplitude output is planar (cols, 2).
    """
    if src.ndim == 3 and not jnp.issubdtype(src.dtype, jnp.complexfloating):
        if use_amplitudes:
            amp = jnp.sqrt(src[..., 0] ** 2 + src[..., 1] ** 2)
            return jnp.dot(mask, amp, precision=_HIGHEST, preferred_element_type=jnp.float32)
        # One matvec over the flattened (rows, 2*cols) view
        rows, cols = src.shape[0], src.shape[1]
        flat = jnp.dot(mask, src.reshape(rows, cols * 2), precision=_HIGHEST,
                       preferred_element_type=jnp.float32)
        return flat.reshape(cols, 2)
    if use_amplitudes:
        return jnp.dot(mask, jnp.abs(src), precision=_HIGHEST,
                       preferred_element_type=jnp.float32)
    # Complex64 matvec: XLA decomposes it into real matvecs.
    return jnp.dot(mask.astype(jnp.complex64), src, precision=_HIGHEST)
