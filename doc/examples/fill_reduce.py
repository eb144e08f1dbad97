#!/usr/bin/env python
"""Compose Fill and HReduce into one OperationSequence.

Analogue of the reference's fill_reduce.py
(reference: doc/user/examples/fill_reduce.py): the compound-slot wiring
table is the same, but the composed sequence compiles to ONE XLA program
— the intermediate `src` buffer never round-trips to HBM if XLA fuses it
(reference OperationSequence re-enqueues one kernel per child,
accel.py:1833-1835).
"""
import numpy as np

from katsdpsigproc_tpu.ops import base, fill, reduce as reduce_op
from katsdpsigproc_tpu.utils import backend

backend.apply_platform_env()


class FillReduceTemplate:
    def __init__(self, context):
        self.fill = fill.FillTemplate(context, np.float32)
        self.hreduce = reduce_op.HReduceTemplate(context, np.float32, op="plus")

    def instantiate(self, queue=None, shape=()):
        return FillReduce(self, shape)


class FillReduce(base.OperationSequence):
    def __init__(self, template, shape):
        self.fill = template.fill.instantiate(shape=shape)
        self.hreduce = template.hreduce.instantiate(shape=shape)
        operations = [("fill", self.fill), ("hreduce", self.hreduce)]
        compounds = {"src": ["fill:data", "hreduce:src"], "dest": ["hreduce:dest"]}
        super().__init__(operations, compounds)
        self.template = template

    def __call__(self, fill_value):
        self.fill.set_value(fill_value)
        return super().__call__()


ctx = backend.create_some_context()
op = FillReduceTemplate(ctx).instantiate(shape=(10, 5))
op(42)
result = np.asarray(op.buffer("dest"))
np.testing.assert_allclose(result, np.full(10, 42.0 * 5))
print(result)
