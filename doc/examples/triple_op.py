#!/usr/bin/env python
"""Triple as an Operation with a Template and an autotuner hook.

Analogue of the reference's full template/operation tutorial
(reference: doc/user/examples/triple_op_template.py, triple_tune.py).
The workflow is the reference's — build a template once, instantiate per
shape, bind buffers, call — but the instantiated operation is a pure
jitted function and the autotuner consults the shipped static table
(reference tune.py's sqlite cache → utils/tune.py).
"""
import jax.numpy as jnp
import numpy as np

from katsdpsigproc_tpu.ops import base
from katsdpsigproc_tpu.utils import backend, tune

backend.apply_platform_env()


class MultiplyTemplate:
    def __init__(self, context, tuning=None):
        if tuning is None:
            tuning = self.autotune(context)
        self.block = tuning["block"]

    @classmethod
    @tune.autotuner(test={"block": 128})
    def autotune(cls, context):
        # No real search dimension under XLA; a real kernel would time
        # candidates with tune.autotune(generate, block=[...]).
        return {"block": 256}

    def instantiate(self, command_queue=None, size=0, scale=1.0):
        return Multiply(self, size, scale)


class Multiply(base.Operation):
    def __init__(self, template, size, scale):
        super().__init__()
        self.template = template
        self.scale = np.float32(scale)
        self.slots["data"] = base.Slot((size,), np.float32, base.Direction.IN)
        self.slots["out"] = base.Slot((size,), np.float32, base.Direction.OUT)

    def _run(self, data):
        return {"out": data * self.scale}

    def parameters(self):
        return {"scale": float(self.scale), "block": self.template.block}


ctx = backend.create_some_context()
op = MultiplyTemplate(ctx).instantiate(size=50, scale=3.0)

# Functional style:
host = np.random.uniform(size=50).astype(np.float32)
out = op(data=jnp.asarray(host))["out"]
np.testing.assert_allclose(np.asarray(out), host * 3)

# Reference bind-then-call style (doc/user/operations.rst:116-145):
op.bind(data=jnp.asarray(host))
op()
np.testing.assert_allclose(np.asarray(op.buffer("out")), host * 3)
print(np.asarray(op.buffer("out"))[:5], op.parameters())
