"""SA Tableau Search in JAX.

A JAX/XLA/Pallas reimplementation of the capabilities of the CUDA
"SA Tableau Search" protein-substructure search program (reference:
stivalaa/cuda_satabsearch), running on an NVIDIA GPU (H100):

* the simulated-annealing matching kernel runs one thread per chain and
  one program per (query, DB entry) pair (Pallas through Triton), with
  a plain-XLA vectorized engine over (db-entry, chain) axes as the
  portable path, both on counter-based threefry streams (no per-thread
  mutable RNG state),
* the database is parsed into padded, size-bucketed dense arrays resident
  in device memory, sharded by entry over a ``jax.sharding.Mesh`` for
  multi-chip / multi-host execution,
* score statistics (norm2 / Gumbel z-score / p-value) and the CLI stdin
  protocol are drop-in compatible with the reference driver.

Package layout:
  core/      constants and code tables (reference: saparams.h, parsetableaux.c)
  io/        ASCII database/query parsing and device array packing
  ops/       golden scalar model + vectorized JAX engine + Pallas kernel
  stats/     score normalization and Gumbel statistics (gumbelstats.c)
  parallel/  device-mesh sharding of the search (no reference equivalent:
             the reference is single-GPU)
  cli/       the ``satabsearch`` command-line driver (cudaSaTabsearch.cu)
  eval/      ROC/AUC evaluation harness (scripts/tsevalutils.py etc.)
  utils/     RNG and gather helpers
"""

__version__ = "0.1.0"
