"""Shard planner: distribute a 2^n state vector over a device mesh.

A JAX-free copy of the JAX package's ``passes/shard.py`` (numpy only):
both packages plan the same ops into the same items.  The top d qubits of
the basis index are the mesh axis (shard-index bits), the low n-d qubits
stay local.  Gates on local qubits run on every shard alone; a gate
touching a GLOBAL qubit is preceded by a planned swap of that global qubit
with a cold local qubit (``SwapItem``): a pairwise exchange of half a
block between two shards (parallel/sharded.py), after which the gate is
local.  The ``pallas`` engine runs the same planner with d = n - 7, so
every fused block lands on the 128 lane qubits (engine/pallas_engine.py).

TWO-LEVEL planning: within a shard the low 7 positions are the lane
region; the planner also relocates crowded shard-high qubits down into
cold lanes via ``LocalSwapItem`` (a transpose inside every shard, no
exchange), so that no op touches more than ``max_local_high`` positions
above the lanes.

Victim choice at both levels: the position whose logical qubit has the
fewest remaining uses (exact remaining-use counts — the correct version of
the reference's usage histogram, cf. defect #5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ir.oplist import Op, permute_basis


@dataclass(frozen=True)
class SwapItem:
    """Exchange the qubits at two PHYSICAL positions (one global, one local)."""

    pos_a: int  # global physical position (>= local_n)
    pos_b: int  # local physical position (< local_n)


@dataclass(frozen=True)
class LocalSwapItem:
    """Exchange two LOCAL positions — a transpose in every shard, no
    exchange between shards."""

    pos_a: int
    pos_b: int


PlanItem = Union[Op, SwapItem, LocalSwapItem]

LANE_REGION = 7  # local positions < 7 live on the 128-lane dimension


@dataclass
class ShardPlan:
    items: List[PlanItem]
    # final_position[q] = physical position of original/logical qubit q at the end
    final_position: np.ndarray
    num_swaps: int
    num_local_swaps: int = 0
    num_qubits: int = 0
    num_global: int = 0

    def ici_bytes(self, real_bytes: int = 4) -> int:
        """Total bytes the plan's SwapItems move between shards, summed
        over all 2^d shards (``real_bytes`` = bytes per real scalar; the
        state is a split re/im pair, so one complex amplitude is
        2*real_bytes).  The name is the JAX package's (its shards talk over
        the chips' interconnect, ICI).

        Per swap, each shard ships EXACTLY half its 2^(n-d) block — the
        analytic minimum for a global<->local qubit exchange: an amplitude
        moves iff its local bit differs from its shard bit, which selects
        exactly half the basis indices (parallel/sharded.py
        ``swap_halves``).  LocalSwapItems are transposes inside every shard:
        zero bytes between shards."""
        per_swap = (1 << (self.num_qubits - 1)) * 2 * real_bytes
        return self.num_swaps * per_swap

    def ici_bytes_per_device(self, real_bytes: int = 4) -> int:
        """Bytes each single shard sends (= receives) over the plan."""
        local_n = self.num_qubits - self.num_global
        return self.num_swaps * (1 << (local_n - 1)) * 2 * real_bytes


def plan_sharded(
    ops: Sequence[Op],
    num_qubits: int,
    num_global: int,
    max_local_high: Optional[int] = None,
    initial_layout: Optional[Sequence[int]] = None,
    restore_layout: bool = False,
    victim_policy: str = "cold",
) -> ShardPlan:
    """Rewrite an op list over logical qubits into physical-position items.

    ``max_local_high``: if set, ops are additionally rewritten to touch at
    most this many local positions >= 7 (LocalSwapItem relocations keep the
    per-shard apply on the wide-matmul path).
    ``initial_layout``: position of each logical qubit at entry (default
    identity) — lets multi-part programs (prefix/body/suffix) chain plans.
    ``restore_layout``: append swaps returning every qubit to its initial
    position, making the plan layout-closed (required for on-device
    iteration of a repeated block).
    ``victim_policy``: which local position an incoming global qubit
    displaces — "cold" (default: fewest remaining uses, the corrected
    version of the reference's usage histogram) or "first" (lowest free
    slot, the baseline the A/B in tests/test_sharded.py measures against).
    """
    if victim_policy not in ("cold", "first"):
        raise ValueError(f"unknown victim_policy {victim_policy!r}")
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
    if max_local_high is not None and widest > LANE_REGION + max_local_high:
        max_local_high = widest - LANE_REGION  # cannot do better than width

    if initial_layout is None:
        pos_of = list(range(n))
    else:
        pos_of = [int(p) for p in initial_layout]
    qubit_at = [0] * n
    for q, p in enumerate(pos_of):
        qubit_at[p] = q
    entry_layout = list(pos_of)

    remaining = np.zeros(n, dtype=np.int64)
    for op in ops:
        for q in op.qubits:
            remaining[q] += 1

    items: List[PlanItem] = []
    num_swaps = 0
    num_local_swaps = 0

    def do_swap(p_global: int, p_local: int) -> None:
        nonlocal num_swaps
        items.append(SwapItem(p_global, p_local))
        num_swaps += 1
        qg, ql = qubit_at[p_global], qubit_at[p_local]
        qubit_at[p_local], qubit_at[p_global] = qg, ql
        pos_of[qg], pos_of[ql] = p_local, p_global

    def do_local_swap(pa: int, pb: int) -> None:
        nonlocal num_local_swaps
        items.append(LocalSwapItem(pa, pb))
        num_local_swaps += 1
        qa, qb = qubit_at[pa], qubit_at[pb]
        qubit_at[pa], qubit_at[pb] = qb, qa
        pos_of[qa], pos_of[qb] = pb, pa

    for op in ops:
        qs = op.qubits
        for q in qs:
            p = pos_of[q]
            if p < local_n:
                continue
            # q is global: swap with the coldest local position not used by
            # the op, preferring lane-region slots (< 7) so the per-shard
            # apply stays on the wide-matmul path
            cands = [l for l in range(local_n) if qubit_at[l] not in qs]
            if victim_policy == "first":
                victim = cands[0]
            else:
                victim = min(
                    cands,
                    key=lambda l: (remaining[qubit_at[l]], l >= LANE_REGION, l),
                )
            do_swap(p, victim)

        if max_local_high is not None and local_n > LANE_REGION:
            # second level: too many shard-high positions in one op -> move
            # the overflow into cold lanes (local transposes, no exchange)
            while sum(1 for q in qs if pos_of[q] >= LANE_REGION) > max_local_high:
                q_high = max(
                    (q for q in qs if pos_of[q] >= LANE_REGION),
                    key=lambda q: pos_of[q],
                )
                cands = [
                    l for l in range(LANE_REGION) if qubit_at[l] not in qs
                ]
                victim = min(cands, key=lambda l: (remaining[qubit_at[l]], l))
                do_local_swap(victim, pos_of[q_high])

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

    if restore_layout:
        # make the plan layout-closed: return every qubit to entry_layout.
        # Transpositions: local-local -> LocalSwapItem; global-local ->
        # SwapItem; global-global -> 3 SwapItems through a local bridge.
        for q in range(n):
            want = entry_layout[q]
            cur_p = pos_of[q]
            if cur_p == want:
                continue
            a, b = cur_p, want  # move q from a to b (displacing whoever is at b)
            if a < local_n and b < local_n:
                do_local_swap(a, b)
            elif a >= local_n and b >= local_n:
                bridge = 0  # any local slot works; it is restored below
                do_swap(a, bridge)
                do_swap(b, bridge)
                do_swap(a, bridge)
            elif a >= local_n:
                do_swap(a, b)
            else:
                do_swap(b, a)
        assert list(pos_of) == entry_layout

    return ShardPlan(items, np.asarray(pos_of), num_swaps, num_local_swaps,
                     num_qubits=n, num_global=d)
