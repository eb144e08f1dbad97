"""Multi-host bring-up helpers.

The reference has no distributed runtime (SURVEY.md §2.5); the scaling
model here is: one process per host, globally initialized through
``jax.distributed``, with every collective in
:mod:`katsdpsigproc_tpu.parallel.collectives` riding the interconnect
within a host and the network across hosts.  Failure model matches the reference's scope
(SURVEY.md §5 "Failure detection"): multi-host runs fail fast — any
process error aborts the job; there is no elastic recovery.
"""

import logging
from typing import Optional

import jax

from . import mesh as mesh_mod

_logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (idempotent on single host).

    On a managed cluster the arguments may be discovered from the
    environment (``jax.distributed.initialize()`` with no arguments);
    elsewhere pass the coordinator address, process count and process id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    except RuntimeError as exc:
        # Only double-initialization is benign (idempotency); a genuine
        # bring-up failure (bad coordinator, timeout) must fail fast —
        # the reference-scope failure model (SURVEY.md §5).  Message
        # variants across jax versions: "already initialized" and
        # "should only be called once".
        msg = str(exc).lower()
        if "already initialized" in msg or "only be called once" in msg:
            _logger.debug("jax.distributed.initialize skipped: %s", exc)
        else:
            raise


def pod_mesh(
    baseline_shards: Optional[int] = None,
    channel_shards: int = 1,
):
    """Build the production mesh over every device of the job.

    Baselines×polarizations shard over ``baseline_shards`` (default: all
    devices / channel_shards); lay the channel axis over physically
    adjacent devices so halo exchanges stay between neighbours.
    """
    n = jax.device_count()
    if baseline_shards is None:
        baseline_shards = n // channel_shards
    if baseline_shards * channel_shards != n:
        raise ValueError(
            f"mesh {baseline_shards}x{channel_shards} != device count {n}"
        )
    return mesh_mod.make_mesh(
        (baseline_shards, channel_shards),
        (mesh_mod.BASELINE_AXIS, mesh_mod.CHANNEL_AXIS),
    )


def process_summary() -> str:
    """Human-readable placement summary for logs."""
    return (
        f"process {jax.process_index()}/{jax.process_count()}, "
        f"{jax.local_device_count()} local of {jax.device_count()} devices"
    )
