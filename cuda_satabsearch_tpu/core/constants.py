"""Algorithm constants for SA tableau search.

Values mirror the reference compile-time configuration
(/root/reference/nvcc_src_current/saparams.h:15-46) but are runtime
configuration here -- there is no reason to bake them into a compile on
the device; they simply key the jit cache.
"""

from dataclasses import dataclass

# Maximum size of tableaux / distance matrices that can be read
# (saparams.h:15).  Entries larger than this are skipped with a warning.
MAXDIM = 111

# The reference splits the DB at 96 SSEs ("small" fits GPU shared memory,
# saparams.h:18).  Here the DB is packed into several padded size
# buckets instead, of which 96 is merely one boundary kept for
# familiarity; the kernel reads every width through L1.  See io/pack.py.
MAXDIM_SMALL = 96

# Max length of structure labels, e.g. "d1ubia_" (saparams.h:25).
LABELSIZE = 8

# SSE distance-difference threshold in Angstroms (saparams.h:28): a pair
# of matched SSE pairs only contributes tableau score when
# |dmat1[i,k] - dmat2[j,l]| <= MXSSED.
MXSSED = 4.0

# Iterations of the cooling schedule per restart (saparams.h:31).
MAXITER = 100

# Initial temperature (saparams.h:34).
TEMP0 = 10.0

# Geometric cooling factor per iteration (saparams.h:37).
ALPHA = 0.95

# Default number of restarts (saparams.h:40).
DEFAULT_MAXSTART = 128

# Probability of attempting an initial match per query SSE in thinit
# (saparams.h:43).
INIT_MATCHPROB = 0.5

# Epsilon guard so that trunc((u - EPS) * n) < n even for u == 1.0
# (cudaSaTabsearch_kernel.cu:67).  Kept although our uniforms are in
# [0, 1): it also maps u == 0.0 to index 0 under truncation-toward-zero.
EPS = 1.1e-7

# Sentinel for "maxscore" initialisation (cudaSaTabsearch_kernel.cu:1009).
MAXSCORE_INIT = -99999

# Gumbel distribution parameters (MLE fit on query200 at 4096 restarts,
# gumbelstats.h:21-23).
GUMBEL_A = 0.3780327676087335
GUMBEL_B = 0.3582596175507505


@dataclass(frozen=True)
class SAParams:
    """Runtime-tunable SA parameters.

    Hashable/frozen so it can be a jit static argument.
    """

    maxiter: int = MAXITER
    temp0: float = TEMP0
    alpha: float = ALPHA
    mxssed: float = MXSSED
    init_matchprob: float = INIT_MATCHPROB
    eps: float = EPS
    maxscore_init: int = MAXSCORE_INIT


DEFAULTS = SAParams()
