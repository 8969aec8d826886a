"""Per-block cost classes of the wide (``mxu``) engine's fusion cost model.

A JAX-free copy of ``kh_block_costs`` from the JAX package's
``utils/roofline.py``.  The two tuples are that package's calibration:
per-block times by kh class (the number of high qubits in a fused block)
measured on its original accelerator, not on the card.  They stay as they
are because the native fuser (csrc/qsim_fuse.cpp) uses them to choose
which open block absorbs a gate, and both packages must fuse a circuit
into the same ops.  Only their ratios enter the fuser; no figure here is a
time of the port.  The roofline accounting with the card's own rates
(``wide_program_cost``) is ROADMAP queue A, "Card policies".
"""

from __future__ import annotations

# Two regimes of the JAX package's calibration: a working set below its
# device memory's bandwidth bound (cost ~ 2^kh, anchored at n = 20) and a
# bandwidth-bound one (flat-ish, anchored at n = 24).
_KH_COSTS_COMPUTE_BOUND = (0.0214, 0.0468, 0.1028)
_KH_COSTS_HBM_BOUND = (0.863, 1.014, 1.767)


def kh_block_costs(num_qubits: int) -> tuple:
    """Per-block cost by kh class for the fusion emitter's cost model.

    Only the ratios matter, so the anchor closest to the requested state
    size is returned un-rescaled, as in the JAX package.
    """
    return (_KH_COSTS_COMPUTE_BOUND if num_qubits <= 21
            else _KH_COSTS_HBM_BOUND)
