#!/usr/bin/env python
"""Triple an array: the simplest "kernel" is a jitted pure function.

The reference's first tutorial step writes a CUDA-C/OpenCL-C kernel and
enqueues it by hand (reference: doc/user/examples/triple.py).  Under XLA the
equivalent of a trivial elementwise kernel is just a jitted function —
XLA generates the vectorized device loop.
"""
import jax
import jax.numpy as jnp
import numpy as np

from katsdpsigproc_tpu.utils import backend

backend.apply_platform_env()


@jax.jit
def triple(x):
    return x * 3


host = np.random.uniform(size=50).astype(np.float32)
out = np.asarray(triple(jnp.asarray(host)))
np.testing.assert_allclose(out, host * 3)
print(out[:5])
