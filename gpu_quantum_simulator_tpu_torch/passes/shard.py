"""Low-region planner: rewrite fused ops onto positions 0..local_n-1.

A JAX-free copy of the arm of the JAX package's ``passes/shard.py`` that
the ``pallas`` engine runs (numpy only): the top d qubits of the basis
index are the "global" region, the low n-d qubits stay local.  A gate
touching a global qubit is preceded by a planned swap of that qubit with
a cold local qubit (``SwapItem``).  The ``pallas`` engine runs it with
d = n - 7, so every fused block lands on the 128 lane qubits
(engine/pallas_engine.py).  The JAX planner's other options (device-local
swaps, layout restore, the "first" victim policy) serve its mesh-sharded
engines, ROADMAP queue A, "parallel/ on torch.distributed", and come
with them.

Victim choice: the position whose logical qubit has the fewest remaining
uses (exact remaining-use counts — the correct version of the
reference's usage histogram, cf. defect #5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np

from ..ir.oplist import Op, permute_basis


@dataclass(frozen=True)
class SwapItem:
    """Exchange the qubits at two PHYSICAL positions (one global, one local)."""

    pos_a: int  # global physical position (>= local_n)
    pos_b: int  # local physical position (< local_n)


PlanItem = Union[Op, SwapItem]

LANE_REGION = 7  # local positions < 7 live on the 128-lane dimension


@dataclass
class ShardPlan:
    items: List[PlanItem]
    # final_position[q] = physical position of original/logical qubit q at the end
    final_position: np.ndarray
    num_swaps: int
    num_qubits: int = 0
    num_global: int = 0


def plan_sharded(ops: Sequence[Op], num_qubits: int,
                 num_global: int) -> ShardPlan:
    """Rewrite an op list over logical qubits into physical-position items,
    starting from the identity layout."""
    n, d = num_qubits, num_global
    local_n = n - d
    if local_n < 1:
        raise ValueError("need at least one local qubit")
    widest = max((op.width for op in ops), default=1)
    if widest > local_n:
        raise ValueError(
            f"an op touches {widest} qubits but only {local_n} are local; "
            f"lower max_fused_qubits or use fewer mesh devices"
        )

    pos_of = list(range(n))
    qubit_at = list(range(n))

    remaining = np.zeros(n, dtype=np.int64)
    for op in ops:
        for q in op.qubits:
            remaining[q] += 1

    items: List[PlanItem] = []
    num_swaps = 0

    for op in ops:
        qs = op.qubits
        for q in qs:
            p = pos_of[q]
            if p < local_n:
                continue
            # q is global: swap with the coldest local position not used by
            # the op, preferring lane-region slots (< 7) so the per-device
            # apply stays on the wide-matmul fast path
            cands = [l for l in range(local_n) if qubit_at[l] not in qs]
            victim = min(
                cands,
                key=lambda l: (remaining[qubit_at[l]], l >= LANE_REGION, l),
            )
            items.append(SwapItem(p, victim))
            num_swaps += 1
            qv = qubit_at[victim]
            qubit_at[victim], qubit_at[p] = q, qv
            pos_of[q], pos_of[qv] = victim, p

        new_ps = tuple(pos_of[q] for q in qs)
        if op.kind == "cx":
            items.append(Op("cx", new_ps))
        else:
            order = np.argsort(new_ps)
            sorted_ps = tuple(int(new_ps[i]) for i in order)
            if sorted_ps == new_ps:
                items.append(Op("u", new_ps, op.u))
            else:
                u = permute_basis(op.u, list(new_ps), list(sorted_ps))
                items.append(Op("u", sorted_ps, u))
        for q in qs:
            remaining[q] -= 1

    return ShardPlan(items, np.asarray(pos_of), num_swaps,
                     num_qubits=n, num_global=d)
