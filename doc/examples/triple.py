"""Hello-world: a custom Pallas kernel scaling an array.

The counterpart of the reference's first example (reference:
doc/user/examples/triple.py — an OpenCL-C kernel compiled at runtime):
here the "kernel source" is a Python function that Pallas lowers through
Triton for the GPU, specialized when traced.  On the CPU, where there is no
GPU compiler, the same kernel runs in Pallas's interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from katsdpsigproc_tpu.utils import backend

backend.apply_platform_env()


def multiply_kernel(scale_ref, data_ref, out_ref):
    out_ref[...] = data_ref[...] * scale_ref[0]


def multiply(data, scale):
    return pl.pallas_call(
        multiply_kernel,
        out_shape=jax.ShapeDtypeStruct(data.shape, data.dtype),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4),
        interpret=jax.devices()[0].platform == "cpu",
    )(jnp.asarray([scale], jnp.float32), data)


if __name__ == "__main__":
    host = np.random.uniform(size=(8, 128)).astype(np.float32)
    out = multiply(jnp.asarray(host), 3.0)
    np.testing.assert_allclose(np.asarray(out), host * 3.0, rtol=1e-6)
    print(np.asarray(out))
