"""2-D transpose (corner turn).

Reference: src/katsdpsigproc/transpose.py:39-174 plus the tiled
local-memory kernel machinery in transpose.mako:44-73 and
transpose_base.mako:34-137 (bank-conflict padding, diagonal block remap).

Design: the corner turn is ``jnp.swapaxes``.  XLA's GPU backend emits its
own shared-memory tiled transpose kernel for it — the same idea as the
reference's ``transpose.mako`` — for real, complex and planar
(rows, cols, 2) inputs alike, so no hand-written kernel and no tuning
dimension remain (the reference tunes block/vtx/vty with a 32 KiB
local-memory guard, transpose.py:95-108).  ``tuning`` is accepted for
signature parity and ignored.
"""

from typing import Any, Mapping, Optional, Tuple

import jax.numpy as jnp

from . import base


class TransposeTemplate:
    """Kernel for transposing a 2D array of data.

    Parameters
    ----------
    context
        Placement context.
    dtype
        Element type.
    ctype
        Ignored (API parity with the reference).
    tuning
        Accepted for signature parity and ignored (no search dimension).
    """

    def __init__(self, context, dtype, ctype: Optional[str] = None, tuning=None) -> None:
        self.context = context
        self.dtype = jnp.dtype(dtype)
        self.ctype = ctype

    def instantiate(self, command_queue=None, shape: Tuple[int, int] = (0, 0), allocator=None):
        return Transpose(self, shape)


class Transpose(base.Operation):
    """Concrete instance of :class:`TransposeTemplate`.

    .. rubric:: Slots

    **src** : (rows, cols) input
    **dest** : (cols, rows) output
    """

    def __init__(self, template: TransposeTemplate, shape: Tuple[int, int]) -> None:
        super().__init__()
        self.template = template
        self.shape = tuple(shape)
        self.slots["src"] = base.Slot(shape, template.dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[1], shape[0]), template.dtype, base.Direction.OUT)

    def _run(self, src):
        return {"dest": transpose(src)}

    def parameters(self) -> Mapping[str, Any]:
        return {"dtype": self.template.dtype, "shape": self.shape}


def transpose(src):
    """Swap the first two axes of `src` (a trailing planar axis stays put)."""
    return jnp.swapaxes(src, 0, 1)
