"""Device-mesh distribution of the database entry axis.

The reference is a single-GPU program; its only scaling story is
independent SLURM jobs (SURVEY §2.4).  Here distribution is first-class:
a 1-D ``jax.sharding.Mesh`` over all local (or all global) devices, the
packed DB's entry axis sharded across it, queries replicated, and the
per-entry score vector produced sharded and gathered on the host --
the multi-card analog of the reference's one-time cudaMemcpy3D of the DB
(cudaSaTabsearch.cu:924-963) amortized across a query stream.

Because the SA search is embarrassingly parallel over DB entries, no
collectives are needed inside the kernel at all: the engine's inputs
are sharded and XLA's SPMD partitioner places each entry's chains on its
shard's device; the GPU kernel runs under jax.shard_map on each card's
slice.  The only cross-device traffic is the [N]-sized int32 score
gather at the end, trivial bandwidth over NVLink.

Multi-host: call ``jax.distributed.initialize()`` before building the
mesh with ``devices=jax.devices()``; every process executes the same
program and ``np.asarray`` on the addressable shards assembles local
results (fully-replicated gather requires ``all_local`` assembly via
``multihost_utils`` -- see ``gather_scores``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENTRY_AXIS = "entries"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: all devices)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ENTRY_AXIS,))


def entry_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (the DB entry axis) across the mesh."""
    return NamedSharding(mesh, P(ENTRY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def gather_scores(x) -> np.ndarray:
    """Assemble a (possibly sharded) device array on the host — the
    single multi-host gather implementation lives in
    parallel.distributed.to_host; this name is kept for the public
    parallel API."""
    from .distributed import to_host

    return to_host(x)
