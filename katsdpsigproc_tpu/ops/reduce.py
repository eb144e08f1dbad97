"""Row-wise reduction with a user-supplied commutative operator.

Reference: src/katsdpsigproc/reduce.py:22-214 (HReduceTemplate/HReduce) over
hreduce.mako + wg_reduce.mako — each row of a 2-D array is reduced across a
column range with a caller-supplied C expression and identity.

Design: the operator is a JAX binary callable (or a named
operator from :mod:`.wgreduce`) instead of a C snippet; the reduction is a
single XLA ``reduce`` over the row axis, which the compiler tiles and
vectorizes — the reference's wgsx/wgsy work-group search
(reduce.py:56-74) has no analogue, so this template has **no autotune**
and ``tuning`` is accepted for signature parity and ignored.
``column_range`` mirrors reduce.py:125-186.
"""

from typing import Any, Callable, Mapping, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from . import base, wgreduce


class HReduceTemplate:
    """Performs reduction along rows in a 2D array.

    Only commutative reduction operators are supported.

    Parameters
    ----------
    context
        Placement context.
    dtype
        Element type.
    op
        Either a name from :mod:`katsdpsigproc_tpu.ops.wgreduce`
        (``"plus"``, ``"max"``, ``"min"``, ``"fmin"``, ``"fmax"``) or a
        binary JAX callable combining two values.
    identity
        Identity value for `op` (required for callables; ignored for named
        operators, which know their own).
    """

    def __init__(
        self,
        context,
        dtype,
        ctype: Optional[str] = None,
        op: Union[str, Callable] = "plus",
        identity: Any = None,
        extra_code: str = "",
        tuning=None,
    ) -> None:
        self.context = context
        self.dtype = jnp.dtype(dtype)
        self.ctype = ctype
        self.extra_code = extra_code
        if isinstance(op, str):
            self.reduce_op = wgreduce.BY_NAME[op]
            self.op = op
            self.identity = identity
        else:
            ident = identity
            self.reduce_op = wgreduce.ReduceOp("custom", op, lambda dt: jnp.asarray(ident, dt))
            self.op = op
            self.identity = identity

    def instantiate(
        self,
        command_queue=None,
        shape: Tuple[int, int] = (0, 0),
        column_range: Optional[Tuple[int, int]] = None,
        allocator=None,
    ):
        return HReduce(self, shape, column_range)


class HReduce(base.Operation):
    """Concrete instance of :class:`HReduceTemplate`.

    In each row, the elements in the specified column range are reduced
    using the template's operator.

    .. rubric:: Slots

    **src** : (rows, columns) input
    **dest** : (rows,) output
    """

    def __init__(
        self,
        template: HReduceTemplate,
        shape: Tuple[int, int],
        column_range: Optional[Tuple[int, int]] = None,
    ) -> None:
        if len(shape) != 2:
            raise ValueError("shape must be 2-dimensional")
        if column_range is None:
            column_range = (0, shape[1])
        if column_range[0] < 0 or column_range[1] > shape[1]:
            raise ValueError("column range overflows the array")
        if column_range[0] >= column_range[1]:
            raise ValueError("column range is empty")
        super().__init__()
        self.template = template
        self.shape = tuple(shape)
        self.column_range = column_range
        self.slots["src"] = base.Slot(shape, template.dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((shape[0],), template.dtype, base.Direction.OUT)

    def _run(self, src):
        lo, hi = self.column_range
        sub = src[:, lo:hi]
        op = self.template.reduce_op
        if op.name in wgreduce.BY_NAME:
            result = wgreduce.reduce(sub, op, axis=1)
        else:
            result = jax.lax.reduce(sub, op.identity(sub.dtype), op.combine, (1,))
        return {"dest": result.astype(self.template.dtype)}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "dtype": self.template.dtype,
            "shape": self.shape,
            "column_range": self.column_range,
            "op": getattr(self.template.op, "__name__", self.template.op),
        }
