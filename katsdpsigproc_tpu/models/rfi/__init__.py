"""RFI flagging pipelines.

Mirrors the component inventory of the reference's ``rfi`` package
(reference: src/katsdpsigproc/rfi/__init__.py) with a numpy host oracle,
a device pipeline, and the 2-D time–frequency SumThreshold flagger.
"""

# MAD-to-sigma conversion: sigma estimate = MAD_NORMAL * median(|deviations|)
# (reference: rfi/__init__.py:31-35).
MAD_NORMAL = 1.4826

from . import host  # noqa: E402,F401
from . import device  # noqa: E402,F401
from . import twodflag  # noqa: E402,F401

__all__ = ["MAD_NORMAL", "host", "device", "twodflag"]
