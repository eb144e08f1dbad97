"""Reduction-operator library.

The reference ships a Mako metaprogramming library of work-group cooperative
reductions with named operators (reference: src/katsdpsigproc/wg_reduce.mako:
17-33 operator macros, 97-201 raking/shuffle reduction).  XLA's reduction
lowering replaces hand-scheduled tree reductions, so the equivalent here is
a library of *named operator objects* — combine function + identity + NaN
semantics — shared by :mod:`.reduce` (HReduce) and :mod:`.rank`, plus a
:func:`reduce` helper usable in any JAX function (including Pallas kernel
bodies, where ``jnp`` lowers too).
"""

from dataclasses import dataclass
from typing import Callable

import jax.numpy as jnp


@dataclass(frozen=True)
class ReduceOp:
    """A commutative reduction operator (reference: wg_reduce.mako:17-33)."""

    name: str
    combine: Callable
    identity_for: Callable  # dtype -> identity scalar

    def identity(self, dtype):
        return self.identity_for(jnp.dtype(dtype))


def _nan_ignoring(fn):
    def combine(a, b):
        return fn(a, b)

    return combine


#: a + b
plus = ReduceOp("plus", lambda a, b: a + b, lambda dt: jnp.zeros((), dt))
#: max(a, b) — NaN propagates (jnp.maximum semantics)
max_ = ReduceOp(
    "max", jnp.maximum, lambda dt: jnp.asarray(jnp.finfo(dt).min if jnp.issubdtype(dt, jnp.floating) else jnp.iinfo(dt).min, dt)
)
#: min(a, b) — NaN propagates
min_ = ReduceOp(
    "min", jnp.minimum, lambda dt: jnp.asarray(jnp.finfo(dt).max if jnp.issubdtype(dt, jnp.floating) else jnp.iinfo(dt).max, dt)
)
#: fmax: NaN-ignoring max (reference op_fmax, wg_reduce.mako:29-33)
fmax = ReduceOp(
    "fmax",
    lambda a, b: jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a, jnp.maximum(a, b))),
    lambda dt: jnp.asarray(jnp.nan, dt),
)
#: fmin: NaN-ignoring min (reference op_fmin)
fmin = ReduceOp(
    "fmin",
    lambda a, b: jnp.where(jnp.isnan(a), b, jnp.where(jnp.isnan(b), a, jnp.minimum(a, b))),
    lambda dt: jnp.asarray(jnp.nan, dt),
)

BY_NAME = {op.name: op for op in (plus, max_, min_, fmax, fmin)}


def reduce(values, op: ReduceOp, axis=-1):
    """Reduce `values` along `axis` with `op`.

    Usable in any JAX function.  For the NaN-aware
    operators this lowers to masked min/max rather than a sequential fold.
    """
    if op.name == "plus":
        return jnp.sum(values, axis=axis)
    if op.name == "max":
        return jnp.max(values, axis=axis)
    if op.name == "min":
        return jnp.min(values, axis=axis)
    if op.name == "fmax":
        result = jnp.max(jnp.where(jnp.isnan(values), -jnp.inf, values), axis=axis)
        all_nan = jnp.all(jnp.isnan(values), axis=axis)
        return jnp.where(all_nan, jnp.nan, result).astype(values.dtype)
    if op.name == "fmin":
        result = jnp.min(jnp.where(jnp.isnan(values), jnp.inf, values), axis=axis)
        all_nan = jnp.all(jnp.isnan(values), axis=axis)
        return jnp.where(all_nan, jnp.nan, result).astype(values.dtype)
    # Generic fold for user-defined operators: associative tree via lax.reduce
    import jax

    return jax.lax.reduce(
        values, op.identity(values.dtype), lambda a, b: op.combine(a, b), (axis % values.ndim,)
    )


def scan(values, op: ReduceOp, axis=-1, reverse: bool = False, exclusive: bool = False):
    """Inclusive (or exclusive) prefix scan of `values` along `axis` with `op`.

    The work-group-scan analogue of :func:`reduce` (the reference's
    wg_reduce.mako provides only the reduction; the scan is the natural
    companion — SumThreshold-style windowed passes and the
    chunked noise estimates are built from prefix structures).  Named
    operators use XLA's native cumulative lowerings; user-defined
    operators go through ``lax.associative_scan`` (the operator must be
    associative).
    """
    import jax

    if exclusive:
        inclusive = scan(values, op, axis=axis, reverse=reverse, exclusive=False)
        pad_shape = list(values.shape)
        pad_shape[axis % values.ndim] = 1
        identity = jnp.full(pad_shape, op.identity(values.dtype), values.dtype)
        n = values.shape[axis % values.ndim]
        if reverse:
            body = jax.lax.slice_in_dim(inclusive, 1, n, axis=axis % values.ndim)
            return jnp.concatenate([body, identity], axis=axis % values.ndim)
        body = jax.lax.slice_in_dim(inclusive, 0, n - 1, axis=axis % values.ndim)
        return jnp.concatenate([identity, body], axis=axis % values.ndim)

    if op.name == "plus":
        out = jnp.cumsum(jnp.flip(values, axis) if reverse else values, axis=axis)
        return jnp.flip(out, axis) if reverse else out
    if op.name == "max":
        return jax.lax.cummax(values, axis=axis % values.ndim, reverse=reverse)
    if op.name == "min":
        return jax.lax.cummin(values, axis=axis % values.ndim, reverse=reverse)
    if op.name in ("fmax", "fmin"):
        sentinel = -jnp.inf if op.name == "fmax" else jnp.inf
        masked = jnp.where(jnp.isnan(values), sentinel, values)
        cum = (jax.lax.cummax if op.name == "fmax" else jax.lax.cummin)(
            masked, axis=axis % values.ndim, reverse=reverse
        )
        all_nan = cum == sentinel  # no non-NaN seen yet
        return jnp.where(all_nan, jnp.nan, cum).astype(values.dtype)
    return jax.lax.associative_scan(
        op.combine, values, axis=axis % values.ndim, reverse=reverse
    )
