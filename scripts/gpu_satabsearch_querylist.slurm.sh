#!/bin/bash
# SLURM wrapper: query-list search on a GPU node (the L5 layer of the
# reference: gpu.run.cudasatabsearch.querylist.slurm_sript.sh).
#
# Usage: sbatch gpu_satabsearch_querylist.slurm.sh DBFILE QUERYLIST [RESTARTS]
#
# Cluster-level parallelism is unchanged from the reference: independent
# jobs per query list, results concatenated downstream.  Within a job,
# one process drives every card of the node: --mesh shards the DB entry
# axis over all the GPUs it sees.
#SBATCH --job-name=satabsearch
#SBATCH --time=0-4:0:00
#SBATCH --nodes=1
#SBATCH --ntasks=1
#SBATCH --gres=gpu:4
#SBATCH --output=satabsearch-%j.out
#SBATCH --error=satabsearch-%j.err

set -euo pipefail
DBFILE="$1"
QUERYLIST="$2"
RESTARTS="${3:-8192}"
REPO="${SATABSEARCH_REPO:-$(dirname "$0")/..}"

PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
    time python -m cuda_satabsearch_tpu -q "$DBFILE" -r "$RESTARTS" --mesh \
    < "$QUERYLIST"
