"""Multi-process initialization.

The reference is a single desktop process (SURVEY.md section 2.7: its
whole "comm stack" is three in-process mpsc channels); scale-out here
is a new capability. Within one process the sharding layouts
(shard.mesh) already span every visible device; this module is the
thin remaining piece for runs that span OS processes/hosts -- one
process per GPU host, or a multi-process CPU rig for testing.

After ``init_distributed()``, ``jax.devices()`` is the GLOBAL device
list, so every existing layout works unchanged: ``make_mesh()`` spans
all processes, ``shard_state`` builds global arrays from each
process's (replicated) host data, GSPMD partitions the jitted step,
and XLA runs the halo exchanges between processes (gloo between CPU
processes -- tests/test_distributed.py pins a 2-process x 4-device
mesh producing residuals identical to the single-process run).

Pass the coordinator address (``host:port``), the process count and
this process's index explicitly unless the cluster environment
supplies them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     ) -> Tuple[int, int]:
    """jax.distributed.initialize with this framework's conventions.

    Returns ``(process_index, process_count)``. Call ONCE, before any
    jax computation, on every process of the job. All-None arguments
    are left to jax.distributed.initialize's cluster auto-detection.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def shutdown_distributed() -> None:
    """Tear down the coordination service (end of job)."""
    import jax

    jax.distributed.shutdown()


def gather_to_host(x):
    """Full host copy of a (possibly cross-process) sharded array on
    EVERY process -- an allgather, so use for snapshots/diagnostics,
    not per-step. Single-process arrays pass through np.asarray."""
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
