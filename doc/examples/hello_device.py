#!/usr/bin/env python
"""Create a placement context and report the chosen device.

Analogue of the reference's hello_accel.py
(reference: doc/user/examples/hello_accel.py) — device discovery ranks
GPU > CPU the way the reference ranks CUDA > GPU > accelerator, and the env var
``KATSDPSIGPROC_TPU_DEVICE`` pins a device (reference: accel.py:264-271).
"""
from katsdpsigproc_tpu.utils import backend

backend.apply_platform_env()
ctx = backend.create_some_context()
print(f"Successfully created context on {ctx.device} ({ctx.device_kind})")
