"""katsdpsigproc_tpu — a signal-processing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ska-sa/katsdpsigproc (reference: ``/root/reference``): an accelerated-operation
framework (composable ops with shape/padding contracts, a static offline
tuning table, asyncio host pipelining) plus its radio-astronomy workload — a
primitive library (fill, tiled transpose, reductions, masked sum,
rank/percentile selection, FFT) and the full RFI-flagging pipeline
(background median filter → MAD noise estimation → Offringa SumThreshold),
in 1-D and 2-D time–frequency variants, sharded over device meshes.

Package layout
--------------
``ops``
    Primitive operations (the reference's ``fill.py``/``transpose.py``/
    ``reduce.py``/``maskedsum.py``/``percentile.py``/``fft.py`` plus the
    ``rank.mako``/``wg_reduce.mako`` kernel-support libraries, re-designed
    as composable JAX functions).
``models``
    The flagger pipelines (reference ``rfi/``): host oracle, device
    pipeline, and the 2-D SumThreshold flagger.
``parallel``
    Device-mesh sharding, collective rank/percentile reductions, and the
    multi-chip flagger (new capability — the reference is single-device,
    see SURVEY.md §2.5).
``utils``
    Static tuning table (reference ``tune.py``), asyncio resource ordering
    (reference ``resource.py``), device discovery (reference
    ``accel.py:211-365``), and shape/padding contracts.
"""

__version__ = "0.5.0"

# MAD-to-sigma conversion factor (reference: rfi/__init__.py:31-35).
MAD_NORMAL = 1.4826

from . import models, ops, parallel, utils  # noqa: E402,F401
from .models import rfi  # noqa: E402,F401  (mirror the reference's `katsdpsigproc.rfi`)

__all__ = ["MAD_NORMAL", "ops", "models", "parallel", "utils", "rfi", "__version__"]
