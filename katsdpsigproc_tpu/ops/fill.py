"""Fill an array with a constant value.

Reference: src/katsdpsigproc/fill.py:30-148 (FillTemplate/Fill) and
fill.mako:26-32.  Under XLA a fill is a single broadcast — there is no
tuning dimension at all (the reference tunes a work-group size,
fill.py:70-82, a knob that does not exist under XLA), so this template has
**no autotune**: the ``tuning`` argument is accepted for signature parity
and ignored.  The reference additionally fills the pad elements
(fill.mako:26-32, "The pad elements are also filled with this value");
here the op fills exactly the *logical* shape: XLA owns physical layout,
so padding is not addressable and its contents are unobservable — the
reference's padded-fill guarantee is vacuously met.
"""

from typing import Any, Mapping, Optional, Sequence

import jax.numpy as jnp

from . import base


class FillTemplate:
    """Fill a device array with a constant value.

    Parameters
    ----------
    context
        Placement context (kept for API parity; compilation is global)
    dtype
        Element type
    ctype
        Ignored (C type name in the reference; meaningless under XLA)
    tuning
        Accepted for signature parity and ignored — a single XLA
        broadcast has no searchable dimension (the reference's ``wgs``,
        fill.py:70-82, has no analogue)
    """

    def __init__(self, context, dtype, ctype: Optional[str] = None, tuning=None) -> None:
        self.context = context
        self.dtype = jnp.dtype(dtype)
        self.ctype = ctype

    def instantiate(self, command_queue=None, shape: Sequence[int] = (), allocator=None) -> "Fill":
        return Fill(self, shape)


class Fill(base.Operation):
    """Concrete instance of :class:`FillTemplate`.

    .. rubric:: Slots

    **data** : output
        Array filled with the value set by :meth:`set_value`.
    """

    def __init__(self, template: FillTemplate, shape: Sequence[int]) -> None:
        super().__init__()
        self.template = template
        self.shape = tuple(shape)
        self.slots["data"] = base.Slot(shape, template.dtype, base.Direction.OUT)
        self.value = jnp.zeros((), template.dtype)

    def set_value(self, value: Any) -> None:
        self.value = jnp.asarray(value, self.template.dtype)
        self.invalidate()  # value is baked into the trace

    def _run(self):
        return {"data": jnp.full(self.shape, self.value, self.template.dtype)}

    def parameters(self) -> Mapping[str, Any]:
        return {"dtype": self.template.dtype, "shape": self.shape, "value": self.value}
