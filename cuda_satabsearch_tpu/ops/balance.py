"""Mesh load-balance accounting for the entry-sharded DB.

Under a mesh every bucket is padded to a multiple of the device count
(``pack_database(pad_to=...)``) and each device takes an equal slice of
EVERY bucket, so per-device work is equal BY CONSTRUCTION: all entries
of a bucket run the same width, restart count and iteration schedule.
This module turns that claim into numbers counted from shapes: per-shard
work under that split, the padding overhead it pays, and what the
imbalance WOULD be under a naive contiguous entry split (the obvious
alternative, which the reference's multi-GPU story would inherit from a
per-card DB partition).

Work is counted, not timed: one unit is one SA iteration of one chain
on one DB SSE row, so an entry padded to width ``w`` searched with
``restarts`` restarts of ``maxiter`` moves costs
``w * restarts * maxiter`` units.  No device rate enters.
"""

from __future__ import annotations

import numpy as np


def balance_report(db, ndev: int, restarts: int = 128,
                   maxiter: int = 100) -> dict:
    """Per-shard work accounting for a PackedDB on an ndev-device mesh.

    Returns (work in millions of width-iterations, see module doc):
      per_shard_work        [ndev] — bucket-split sharding (ours)
      imbalance             max/mean - 1 over per_shard_work
      per_shard_naive_work  [ndev] — contiguous file-order entry split
      naive_imbalance       max/mean - 1 under that split
      padding_overhead      padded work / real work - 1 (entries padded
                            to their bucket's width, buckets padded to
                            a multiple of ndev)
      entries_per_shard     [ndev] padded entries each device searches
    """
    it = restarts * maxiter / 1e6
    per_shard = np.zeros(ndev)
    entries = np.zeros(ndev)
    real = 0.0
    for b in db.buckets:
        if b.size % ndev:
            raise ValueError(f"bucket of width {b.dim} holds {b.size} "
                             f"entries, not a multiple of {ndev}; pack "
                             f"with pad_to={ndev}")
        per_shard += b.size // ndev * b.dim * it
        entries += b.size // ndev
        valid = np.asarray(b.index) >= 0
        real += float(np.asarray(b.orders)[valid].sum()) * it

    # naive alternative: slice file-order entries into ndev contiguous
    # slabs, each entry at its bucket's padded width
    dims = np.zeros(db.nentries)
    for b in db.buckets:
        idx = np.asarray(b.index)
        dims[idx[idx >= 0]] = b.dim
    bounds = np.linspace(0, db.nentries, ndev + 1).astype(int)
    naive = np.array([dims[bounds[d]:bounds[d + 1]].sum() * it
                      for d in range(ndev)])

    def imb(x):
        return float(x.max() / x.mean() - 1.0) if x.size and x.mean() else 0.0

    return {
        "ndev": ndev,
        "per_shard_work": per_shard.tolist(),
        "imbalance": imb(per_shard),
        "per_shard_naive_work": naive.tolist(),
        "naive_imbalance": imb(naive),
        "padding_overhead": float(per_shard.sum() / real - 1.0)
        if real else 0.0,
        "entries_per_shard": entries.tolist(),
    }


def format_report(rep: dict) -> str:
    return (f"mesh balance ({rep['ndev']} devices): per-shard work "
            f"{rep['per_shard_work'][0]:.1f} M width-iterations x "
            f"{rep['ndev']} (imbalance {rep['imbalance'] * 100:.2f}%), "
            f"vs naive contiguous split "
            f"{rep['naive_imbalance'] * 100:.1f}% imbalanced; "
            f"padding overhead {rep['padding_overhead'] * 100:.1f}%")
