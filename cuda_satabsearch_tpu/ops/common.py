"""The RNG slot schedule shared by every SA implementation.

The golden model (ops/golden.py), the XLA engine (ops/engine.py) and the
GPU kernel (ops/triton_sa.py) consume one uniform stream per restart at
fixed slots, which is what lets them be tested against each other
bitwise.
"""

from __future__ import annotations

from ..core.constants import DEFAULTS


def round8(x: int) -> int:
    """Query-order padding quantum.  Also keys the RNG slot schedule:
    per restart, slots [0, round8(n1)) feed thinit and slots
    round8(n1) + 3*it + {0,1,2} feed iteration it — so any query order
    in the same round8 bucket shares one compiled kernel AND one stream
    layout (mixed-order query batching)."""
    return max(8, -(-x // 8) * 8)


def slots_per_restart(n1: int, maxiter: int = DEFAULTS.maxiter) -> int:
    """Uniform slots consumed per restart under the n1r schedule."""
    return round8(n1) + 3 * maxiter
