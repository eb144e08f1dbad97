"""Primitive accelerated operations (composable JAX functions)."""

from . import base, fft, fill, maskedsum, percentile, rank, reduce, transpose, wgreduce  # noqa: F401

__all__ = [
    "base",
    "fft",
    "fill",
    "maskedsum",
    "percentile",
    "rank",
    "reduce",
    "transpose",
    "wgreduce",
]
