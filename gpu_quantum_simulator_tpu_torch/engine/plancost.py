"""Plan cost model of the plan portfolio: the JAX package's, copied.

``estimate_plan`` prices a ``PrefetchPlan`` so that ``plan_prefetch_best``
can pick among the plans of several lookahead depths.  It is a JAX-free
copy of ``gpu_quantum_simulator_tpu/engine/plancost.py`` (``tswap_us``,
``estimate_plan`` and the constants they read).

The constants below are the JAX package's TPU calibration.  They stay
because the port's plans must equal the JAX package's: the portfolio keeps
whichever plan this model prices cheapest, so other constants would pick
other plans.  They are not figures of the CUDA card, and the seconds
``estimate_plan`` returns are not a prediction of the port's run time; only
the ranking of candidate plans is used.  A card calibration is queued in
ROADMAP (queue A, "Card policies").  The sharded estimators
(``estimate_plan_sharded``, ``estimate_shard_plan``, ``choose_num_global``)
are copied with the JAX package's exchange constants for the same reason.
The JAX package's measured tswap anchors and its streamed in-place chains
(environment-selected there) have no counterpart here.
"""

from __future__ import annotations

# per-grid-step costs in the JAX package's units (see the module docstring
# of its plancost.py for what each was calibrated on)
US = 1e-6
BASE_STEERED = 10.4
BASE_PLAIN = 6.0
BASE_SPLIT = 8.0
MAT = 5.2
PERM = 3.5
MONO = 3.7
RELAYOUT = 10.9
FOLD_IN = 2.0        # surcharge on the base of a block with a folded relayout
XSWAP_SPLIT = None   # in-place pair-grid swap pass (None -> BASE_PLAIN/2)
DISPATCH_S = 0.030   # per chain part


def tswap_us(k: int) -> float:
    return 1.76 + 0.675 * (k - 1)


def estimate_plan(plan, n: int, inplace: bool = False,
                  fold_relayout: bool = False):
    """(model seconds, breakdown dict) for one PrefetchPlan at width n.

    ``inplace``: the in-place engine's costs (prologues hoisted into
    pair-grid swap passes).  ``fold_relayout``: a relayout followed by a
    plain step block drops its standalone pass and the follower pays
    FOLD_IN on its base (mirrors prefetch._fold_relayout_entries).
    """
    from . import prefetch as P

    T = P.tile_rows(n)
    gs = max((1 << (n - P.LOCAL_QUBITS)) // T, 1)
    logt = plan.logt
    blocks = plan.blocks
    folds_away: set = set()   # relayout entries that fold forward
    fold_into: set = set()    # step blocks paying the folded-input base
    if fold_relayout and not inplace:
        for i in range(len(blocks) - 1):
            b, nxt = blocks[i], blocks[i + 1]
            if (i not in fold_into and b.relayout is not None
                    and not b.kinds and nxt.relayout is None
                    and nxt.gswap is None and nxt.prologue is None
                    and nxt.kinds):
                folds_away.add(i)
                fold_into.add(i + 1)
    acc = {"base": 0.0, "mat": 0.0, "mono": 0.0, "tswap": 0.0, "perm": 0.0,
           "relayout": 0.0, "xswap": 0.0}
    for i, b in enumerate(blocks):
        if b.relayout is not None:
            if i not in folds_away:
                acc["relayout"] += RELAYOUT * gs
            continue
        if b.gswap is not None:
            continue
        if inplace and b.prologue is not None:
            acc["xswap"] += (XSWAP_SPLIT * gs if XSWAP_SPLIT is not None
                             else BASE_PLAIN * gs / 2)
            base = BASE_SPLIT
        else:
            base = (BASE_SPLIT if inplace else
                    BASE_STEERED if b.prologue is not None else BASE_PLAIN)
        if i in fold_into:
            base += FOLD_IN
        acc["base"] += base * gs
        for kind in b.kinds:
            if kind == 0:
                acc["mat"] += MAT * gs
            elif kind == logt + 1:
                acc["perm"] += PERM * gs
            elif kind == logt + 2:
                acc["mono"] += MONO * gs
            else:
                acc["tswap"] += tswap_us(kind) * gs
    total = sum(acc.values()) * US
    # chain parts: approximate with the real chunker on the block count
    max_chunk = max(32, P.DISPATCH_GRID_BUDGET // gs)
    nparts = len(P._chunks(len(blocks) - len(folds_away), max_chunk))
    total += nparts * DISPATCH_S
    acc["dispatch_parts"] = nparts
    return total, acc


# The JAX package's planning constants for the exchange between shards:
# its chips' interconnect (ICI) rate and latency and its elementwise memory
# pass rate.  They are not figures of the card or of a copy between
# shards on it; they stay so that the sharded portfolio and
# ``choose_num_global`` pick the JAX package's plans (ROADMAP queue A,
# "Card policies").
ICI_GBS = 45.0
GSWAP_LAT_US = 25.0
HBM_EFF_GBS = 233.0


def estimate_plan_sharded(plan, n: int, d: int):
    """(model seconds, breakdown) for a mesh plan: local steps at nl = n - d
    on every shard (all shards in parallel) plus the gswap half-block
    exchanges."""
    nl = n - d
    secs, acc = estimate_plan(plan, nl)
    gswap_us = (1 << nl) * 4 / (ICI_GBS * 1e9) * 1e6 + GSWAP_LAT_US
    acc["gswap"] = plan.num_gswaps * gswap_us * US
    return secs + acc["gswap"], acc


def estimate_shard_plan(plan, n: int):
    """(model seconds, breakdown) for a dense-engine ``ShardPlan``
    (passes/shard.py over parallel/sharded.py).

    Every plan item is one pass over each shard's 2^(n-d) block (read and
    write at HBM_EFF_GBS); a ``SwapItem`` also ships half the block to the
    partner shard.  That term is the plan's own byte count,
    ``plan.ici_bytes_per_device()``, spread over its swaps, at ICI_GBS,
    plus GSWAP_LAT_US an exchange.  All shards run in parallel, so
    per-shard seconds are plan seconds.
    """
    from ..passes.shard import LocalSwapItem, SwapItem

    nl = n - plan.num_global
    blk_bytes = 2 * (1 << nl) * 4           # split re/im float32 block
    pass_s = 2 * blk_bytes / (HBM_EFF_GBS * 1e9)   # read + write
    per_swap = (plan.ici_bytes_per_device() // plan.num_swaps
                if plan.num_swaps else 0)
    swap_ici_s = per_swap / (ICI_GBS * 1e9) + GSWAP_LAT_US * US
    acc = {"ops": 0.0, "local_swaps": 0.0, "gswap_ici": 0.0,
           "gswap_hbm": 0.0}
    for it in plan.items:
        if isinstance(it, SwapItem):
            acc["gswap_ici"] += swap_ici_s
            acc["gswap_hbm"] += pass_s      # select + reassemble the halves
        elif isinstance(it, LocalSwapItem):
            acc["local_swaps"] += pass_s
        else:
            acc["ops"] += pass_s
    return sum(acc.values()), acc


def choose_num_global(ops, n: int, num_devices: int, segmented: bool = False,
                      victim_policy: str = "cold", max_local_high=None):
    """Pick the mesh split d (the number of shard-index qubits) by model
    seconds: ``(best_d, {d: model seconds})``.

    Plans each candidate d in 1..log2(num_devices) with the matching
    planner (dense ``ShardPlan``, or the prefetch planner at
    ``num_global=d``) and prices it; a larger d halves every local pass
    but adds exchanges.  Candidates with an op wider than the local region
    are skipped.
    """
    import math

    from ..passes.shard import plan_sharded

    max_d = int(math.log2(num_devices))
    scores = {}
    for d in range(1, max_d + 1):
        try:
            if segmented:
                from . import prefetch as P

                plan = P.plan_prefetch(ops, n, num_global=d)
                secs, _ = estimate_plan_sharded(plan, n, d)
            else:
                plan = plan_sharded(ops, n, d, victim_policy=victim_policy,
                                    max_local_high=max_local_high)
                secs, _ = estimate_shard_plan(plan, n)
        except ValueError:
            continue
        scores[d] = secs
    if not scores:
        raise ValueError(f"no feasible mesh split for n={n} over "
                         f"{num_devices} devices")
    return min(scores, key=scores.get), scores
