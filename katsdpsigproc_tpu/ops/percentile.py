"""Per-row [0, 100, 25, 75, 50] percentiles of positive data.

Reference: src/katsdpsigproc/percentile.py:34-217 and percentile.mako:
115-140 — per row: min, max, and the lower-element (non-interpolated)
25th/75th/50th percentiles at ranks ``(n-1)//4``, ``3*(n-1)//4``,
``(n-1)//2``, assuming positive values; complex input is reduced to
amplitudes first.  Matches ``np.percentile(..., interpolation='lower')``
exactly (reference test/test_percentile.py:47-91).

Design: the ``rank`` engine uses the same bitwise IEEE-754 rank search as
the reference (rank.mako:186-231, here :mod:`.rank`) — fully-vectorized
compare-count rounds, batched over rows, which also extends to sharded
columns via psum (see :mod:`katsdpsigproc_tpu.parallel.collectives`).  The
``sort`` engine (``jnp.sort`` + gather) is the alternative; both are exact,
and the tuning table picks between them per device.  ``column_range``
mirrors percentile.py:123-130.
"""

from typing import Any, Mapping, Optional, Tuple

import jax.numpy as jnp

from ..utils import tune
from . import base, rank


class Percentile5Template:
    """Kernel for calculating percentiles of a 2D array of data.

    5 percentiles [0,100,25,75,50] are calculated per row (along columns,
    independently per row).  The lower percentile element, rather than a
    linear interpolation, is chosen.  WARNING: assumes all values are
    positive when ``is_amplitude`` is true.

    Parameters
    ----------
    context
        Placement context.
    max_columns
        Maximum number of columns (API parity; the tuning search's width)
    is_amplitude
        If true, the inputs are scalar amplitudes; if false they are
        complex64 and percentiles are computed on absolute values.
    tuning
        ``engine``: ``"rank"`` (bitwise binary search) or ``"sort"``.
    """

    autotune_version = 9

    def __init__(self, context, max_columns: int, is_amplitude: bool = True, tuning=None) -> None:
        self.context = context
        self.max_columns = max_columns
        self.is_amplitude = is_amplitude
        if tuning is None:
            tuning = self.autotune(context, max_columns, is_amplitude)
        self.engine = tuning.get("engine", "rank")

    @classmethod
    @tune.autotuner(test={"engine": "rank"})
    def autotune(cls, context, max_columns, is_amplitude) -> Mapping[str, Any]:
        shape = (4096, int(max_columns))
        import numpy as np

        rs = np.random.RandomState(seed=1)
        if is_amplitude:
            host = rs.uniform(size=shape).astype(np.float32)
        else:
            host = (rs.standard_normal(shape) + 1j * rs.standard_normal(shape)).astype(np.complex64)
        data = jnp.asarray(host)

        def generate(engine: str):
            tmpl = cls(context, max_columns, is_amplitude, tuning={"engine": engine})
            op = tmpl.instantiate(None, shape)
            return tune.make_measure(lambda d: op(src=d)["dest"], data)

        return tune.autotune(generate, engine=["rank", "sort"])

    def instantiate(
        self,
        command_queue=None,
        shape: Tuple[int, int] = (0, 0),
        column_range: Optional[Tuple[int, int]] = None,
        allocator=None,
    ):
        return Percentile5(self, shape, column_range)


class Percentile5(base.Operation):
    """Concrete instance of :class:`Percentile5Template`.

    .. rubric:: Slots

    **src** : (rows, cols) float32 or complex64 input
    **dest** : (5, rows) float32 — [min, max, p25, p75, p50] per row
    """

    def __init__(
        self,
        template: Percentile5Template,
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
        if column_range[1] - column_range[0] > template.max_columns:
            raise ValueError("columns exceeds max_columns")
        super().__init__()
        self.template = template
        self.shape = tuple(shape)
        self.column_range = column_range
        in_dtype = jnp.float32 if template.is_amplitude else jnp.complex64
        self.slots["src"] = base.Slot(shape, in_dtype, base.Direction.IN)
        self.slots["dest"] = base.Slot((5, shape[0]), jnp.float32, base.Direction.OUT)

    def _run(self, src):
        lo, hi = self.column_range
        sub = src[:, lo:hi]
        if not self.template.is_amplitude:
            sub = jnp.abs(sub)
        return {"dest": percentile5(sub, engine=self.template.engine)}

    def parameters(self) -> Mapping[str, Any]:
        return {
            "max_columns": self.template.max_columns,
            "is_amplitude": self.template.is_amplitude,
            "shape": self.shape,
            "column_range": self.column_range,
        }


def percentile5(values, engine: str = "rank"):
    """[min, max, p25, p75, p50] per row of positive data (..., n) → (5, ...)."""
    n = values.shape[-1]
    r25 = (n - 1) // 4
    r75 = (3 * (n - 1)) // 4
    r50 = (n - 1) // 2
    if engine == "sort":
        s = jnp.sort(values, axis=-1)
        out = jnp.stack([s[..., 0], s[..., n - 1], s[..., r25], s[..., r75], s[..., r50]])
    elif engine == "rank":
        # One radix search resolves all three ranks at once: the rank axis
        # broadcasts against a single read of the data per round (radix-16
        # digits: 8 sweeps instead of 31).
        targets = jnp.asarray([r25, r75, r50], jnp.int32)
        vb = jnp.broadcast_to(values[..., None, :], values.shape[:-1] + (3, values.shape[-1]))
        p = rank.find_rank_float(vb, targets, False, radix_bits=4)  # (..., 3)
        out = jnp.stack(
            [
                rank.fmin(values),
                rank.fmax(values),
                p[..., 0],
                p[..., 1],
                p[..., 2],
            ]
        )
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return out.astype(jnp.float32)
