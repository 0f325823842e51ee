"""Multi-host initialization and scaling helpers.

The reference has no distributed runtime (single GPU, job-level
SLURM parallelism only; SURVEY §2.4).  Here multi-host scaling is the
standard JAX recipe: ``jax.distributed.initialize()`` on every process,
a global 1-D mesh over all devices, the DB entry axis sharded across it
(parallel/mesh.py), and per-query score vectors assembled with
``process_allgather``.  The SA workload is embarrassingly parallel over
DB entries, so scaling efficiency is bounded only by per-shard launch
overhead and the [N]-int32 score gather.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op when single-process).

    With no arguments, relies on the cluster environment
    (e.g. SLURM) exactly like jax.distributed.initialize.
    """
    if num_processes == 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_primary() -> bool:
    """True on the process that should emit results (process 0)."""
    return jax.process_index() == 0


def to_host(x):
    """Materialize a (possibly multi-host-sharded) array on every host.

    Single-process: a plain device->host transfer.  Multi-process: the
    array's shards live on different hosts, so ``np.asarray`` would
    fail on the non-addressable ones; ``process_allgather`` rides the
    collective fabric to assemble the full value everywhere (the score
    vector is [N] int32 — trivial bandwidth, SURVEY §5)."""
    import numpy as np

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(
            multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)
