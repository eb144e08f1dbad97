#!/usr/bin/env python
"""Triple an array with a hand-written Pallas kernel.

Analogue of the reference's custom-kernel tutorial (reference:
doc/user/examples/triple.py, sum.py — Mako-templated CUDA-C/OpenCL-C
compiled at runtime): the kernel is Python traced by Pallas and lowered
through Triton for the GPU; the grid/BlockSpec play the role of the
reference's global_size/local_size work decomposition.  On the CPU the
same kernel runs in Pallas's interpreter.
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from katsdpsigproc_tpu.utils import backend

backend.apply_platform_env()

BLOCK = 256  # the analogue of the reference kernel's work-group size (a power of 2)


def triple_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 3.0


@jax.jit
def triple(x):
    (n,) = x.shape
    return pl.pallas_call(
        triple_kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(n // BLOCK,),
        in_specs=[pl.BlockSpec((BLOCK,), lambda i: (i,))],
        out_specs=pl.BlockSpec((BLOCK,), lambda i: (i,)),
        backend="triton",
        interpret=jax.devices()[0].platform == "cpu",
    )(x)


host = np.random.uniform(size=4 * BLOCK).astype(np.float32)
out = np.asarray(triple(jnp.asarray(host)))
np.testing.assert_allclose(out, host * 3)
print(out[:5])
