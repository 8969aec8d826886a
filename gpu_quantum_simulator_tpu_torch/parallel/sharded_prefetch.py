"""Mesh-sharded prefetch engine: the distributed twin of engine/prefetch.

The port of the JAX package's ``parallel/sharded_prefetch.py``.  Every
shard holds the LOCAL nl = n - d qubits as the prefetch engine's flat
(R2L, 256) pair; every fused op is a runtime-table 256x256 matmul on the
fixed window, placed by tswap/perm/xswap/relayout steps, and every shard
runs the same entries on the port's flat chain (``engine/prefetch.py``
``run_flat_entry``): kernel 1's blocks, kernel 2's relayouts where
R2L > tile_rows(nl), and the "high"/"default" mat step (3') by rung.

A gate on a MESH-AXIS qubit is preceded by a planned ``gswap`` entry
(scal mode 4): exchange local window bit 7 with shard-index bit g.  It is
an entry of this chain, not a kernel mode: each shard writes its new block
into its own spare pair (the chain's ping-pong buffer), its kept column
half and the partner's shipped half (parallel/sharded.py ``swap_halves``:
on cards one launch a shard of csrc/gswap.cu, pulling the partner's half
over the link), and then swaps pair and spare, so no staging buffer
exists.  Each shard ships exactly half its block.

The circuit's entries are packed into power-of-2 chunks as in the JAX
package (``chunk_sizes``); each chunk is one table part.  The tables stay
on the host as compact factors and are expanded on each distinct mesh
device a group of entries at a time as the chain reaches them, so the
device holds the state, its spare pair and one group's tables (at n = 34
over four cards, a shard of 2^32 amplitudes each: 32 GiB, 32 GiB and a
few hundred MB a card).  The spare pair lives only while a call runs.

Planner: plan_prefetch(num_global=d) — one planner serves both engines.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..engine import prefetch as PF
from ..engine.prefetch import (CAP_MATS, CAP_STEPS, DISPATCH_GRID_BUDGET,
                               DVIEW, LOCAL_QUBITS, MIN_QUBITS,
                               expand_tables, materialize_entries,
                               plan_prefetch, relayout_rows, run_flat_entry,
                               splits_tables, tile_rows)
from ..ir.oplist import Op
from ..kernels.block import RUNGS, SPLIT_RUNGS, split_tables
from ..ops.apply import upload
from .mesh import Mesh, num_global_qubits
from .sharded import (initial_shards, is_sharded, shard_component,
                      swap_halves)

# entries whose tables are expanded at a time (a part holds up to 256 at
# n = 31 over eight shards: about 1 GiB of expanded and split tables)
TABLE_GROUP = 32
# the chain waits for its cards every this many table parts, so that the
# host runs no further ahead of them than that (the JAX package throttles
# its queue of chunks likewise)
SYNC_PARTS = 8


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the block: the hand kernels
    launch on the current device, and a shard may sit on another card than
    the first.  A no-op context for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@telemetry.counted
def gswap(cur, spare, g: int):
    """The mesh gswap entry: window bit 7 (the column half) of every
    shard's (R2L, 256) pair exchanged with shard-index bit ``g``.  Each
    shard's new block is written into its spare pair (allocated when
    None); returns (new cur, new spare).  ``gswap.launches`` counts the
    entries; on cards each is one launch a shard, counted in
    ``sharded.gswap_halves.launches``."""
    re, im = swap_halves([c[0] for c in cur], [c[1] for c in cur], g,
                         LOCAL_QUBITS - 1, out=spare)
    gswap.launches += 1
    return list(zip(re, im)), list(cur)


gswap.launches = 0


class ShardedChain:
    """The materialized entries of a sharded plan and the loop that runs
    them on every shard: one table part a chunk, kept on the host as
    compact factors and expanded a TABLE_GROUP of entries at a time on
    each distinct device of the mesh.  Mode 4 rows are gswaps, every other
    row runs on each shard through ``run_flat_entry``.  ``mode_rows``
    counts the scal rows by mode; ``table_seconds`` is the host's time in
    the last call's table uploads and expansions (queued, not waited
    for).  A call on cards records two CUDA events on the first shard's
    stream, before its first and after its last entry: ``events`` =
    (start, end), the chain's device time.
    """

    def __init__(self, entries, local_qubits: int, devices, cap_steps: int,
                 precision: str):
        nl = local_qubits
        self.devices = list(devices)
        self.cap_steps = cap_steps
        self.precision = precision
        self._R2 = 1 << (nl - LOCAL_QUBITS)
        tr = relayout_rows(nl)
        self._geometry = (int(np.log2(tile_rows(nl))), tr,
                          int(np.log2(self._R2 // tr)))
        self._parts = []
        self.mode_rows: dict = {}
        self.table_seconds = 0.0
        for (_, sizes, scal, *tabs) in entries:
            for mode, cnt in zip(*np.unique(scal[:, 1], return_counts=True)):
                self.mode_rows[int(mode)] = (self.mode_rows.get(int(mode), 0)
                                             + int(cnt))
            off = 0
            for c in sizes:
                self._parts.append((
                    scal[off : off + c].tolist(),
                    [np.ascontiguousarray(t[off : off + c]) for t in tabs]))
                off += c

    def _tables(self, tabs, lo: int, hi: int) -> dict:
        """{device: (a_tab, b_tab, mono_src, high)} of entries lo..hi-1."""
        t0 = time.perf_counter()
        out = {}
        for dev in dict.fromkeys(self.devices):
            with telemetry.span("qsim/tables"):
                a, b, src = expand_tables(*(upload(t[lo:hi], dev)
                                            for t in tabs))
                high = (split_tables(a, b) if self.precision in SPLIT_RUNGS
                        and splits_tables(dev) else None)
            out[dev] = (a, b, src, high)
        self.table_seconds += time.perf_counter() - t0
        return out

    def __call__(self, re, im):
        cur = [(r.reshape(self._R2, DVIEW), i.reshape(self._R2, DVIEW))
               for r, i in zip(re, im)]
        spare = [None] * len(cur)
        self.table_seconds = 0.0
        cards = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        events = None
        if cards:
            events = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            events[0].record(torch.cuda.current_stream(self.devices[0]))
        for k, (scal, tabs) in enumerate(self._parts):
            if k and k % SYNC_PARTS == 0:
                for dev in cards:
                    torch.cuda.current_stream(dev).synchronize()
            tables, lo = None, None
            for i, row in enumerate(scal):
                if row[1] == 4:
                    cur, spare = gswap(cur, spare, row[2])
                    continue
                if lo is None or i >= lo + TABLE_GROUP:
                    tables = None               # freed before the next group
                    lo = i
                    tables = self._tables(tabs, lo, lo + TABLE_GROUP)
                for s, dev in enumerate(self.devices):
                    a, b, src, high = (None if t is None else t[i - lo]
                                       for t in tables[dev])
                    with on_device(dev):
                        out = run_flat_entry(row, cur[s], spare[s], a, b,
                                             src, high, self._geometry,
                                             self.cap_steps, self.precision)
                    if out[0] is not cur[s][0]:
                        spare[s], cur[s] = cur[s], out
            del tables
        if events is not None:
            events[1].record(torch.cuda.current_stream(self.devices[0]))
            self.events = events
        return ([c[0].reshape(-1) for c in cur],
                [c[1].reshape(-1) for c in cur])


class ShardedPrefetchProgram:
    """Segmented sharded execution of one planned circuit.

    ``__call__`` maps a sharded (re, im) state (shard lists; a flat pair is
    split into new shards) through the chain.  The input shards are handed
    over: the chain writes into them and their spare pairs.  With
    ``final_layout`` = identity the program is layout-closed (repetitions
    compose; output in the original basis).  ``build_seconds``: the
    host's planning and packing time.
    """

    def __init__(
        self,
        ops: Sequence[Op],
        num_qubits: int,
        mesh: Mesh,
        axis: str = "amp",
        real_dtype=torch.float32,
        precision: str = "highest",
        cap_steps: int = CAP_STEPS,
        cap_mats: int = CAP_MATS,
        final_layout: Optional[Sequence[int]] = None,
        reorder: bool = True,
    ):
        t0 = time.perf_counter()
        n = num_qubits
        d = int(math.log2(mesh.shape[axis]))
        nl = n - d
        if nl < MIN_QUBITS:
            raise ValueError(
                f"sharded prefetch needs >= {MIN_QUBITS} local qubits "
                f"(n={n}, mesh=2^{d}); use the dense sharded engine")
        if real_dtype != torch.float32:
            raise ValueError(
                "the segmented sharded engine is float32-only; set "
                "shard_segmented=False for complex128 parity checks")
        if precision not in RUNGS:
            raise ValueError(f"precision {precision!r}: the rungs are {RUNGS}")
        if reorder and n >= PF.PORTFOLIO_MIN_QUBITS and len(PF.PLAN_PORTFOLIO) > 1:
            # lookahead-depth portfolio priced with the gswap term
            # (engine/plancost.py), as in the JAX package
            from ..engine import plancost

            best = None
            for waves in PF.PLAN_PORTFOLIO:
                cand = plan_prefetch(
                    ops, n, cap_steps, cap_mats, final_layout=final_layout,
                    reorder=reorder, allow_relayout=True, num_global=d,
                    lookahead_waves=waves)
                secs, _ = plancost.estimate_plan_sharded(cand, n, d)
                if best is None or secs < best[0]:
                    best = (secs, cand)
            plan = best[1]
        else:
            plan = plan_prefetch(
                ops, n, cap_steps, cap_mats, final_layout=final_layout,
                reorder=reorder, allow_relayout=True, num_global=d)
        self.num_qubits = n
        self.num_global = d
        self.mesh = mesh
        self.devices = mesh.device_list
        self.axis = axis
        self.plan = plan
        self.final_position = plan.final_position
        self.num_ops = plan.num_ops
        self.num_entries = len(plan.blocks)
        self.real_dtype = real_dtype
        # per-shard grid rows bound the table chunks (the JAX package's
        # dispatch budget; see prefetch.py DISPATCH_GRID_BUDGET)
        grid_rows = max((1 << max(nl - LOCAL_QUBITS, 0)) // tile_rows(nl), 1)
        max_chunk = max(32, DISPATCH_GRID_BUDGET // grid_rows)
        entries = materialize_entries(
            plan.blocks, cap_steps, cap_mats, np.float32,
            single_class=cap_mats <= 4, max_chunk=max_chunk,
            mono_as_mat=plan.mono_as_mat)
        self.chunk_sizes = [c for e in entries for c in e[1]]
        self._chain = ShardedChain(entries, nl, self.devices, cap_steps,
                                   precision)
        self.build_seconds = time.perf_counter() - t0

    @property
    def mode_rows(self) -> dict:
        return self._chain.mode_rows

    @property
    def table_seconds(self) -> float:
        return self._chain.table_seconds

    def init_state(self, initial_parts=None):
        if initial_parts is None:
            return initial_shards(self.num_qubits, self.devices)
        return tuple(shard_component(x, self.devices)
                     for x in initial_parts)

    def __call__(self, re, im):
        if not is_sharded(re):
            re, im = self.init_state((re, im))
        return self._chain(list(re), list(im))


_RUN_CACHE: dict = {}
_RUN_CACHE_LIMIT = 8


def run_sharded_prefetch(circuit, config, mesh: Mesh, initial_parts=None):
    """Simulator facade entry; returns (re, im, num_items, residual=None)
    with ``re``/``im`` shard lists.

    Mirrors engine.prefetch.run_prefetch: relabel hot qubits low, plan with
    the state routed back to the ORIGINAL basis in-plan (gswap/relayout
    restore steps), cache the program by circuit fingerprint and mesh.
    """
    from ..config import resolve_precision
    from ..engine.prefetch import LANE_QUBITS, _circuit_fingerprint
    from ..engine.simulator import _fuse_pipeline
    from ..passes.permute import plan_permutation, unpermute_state

    n = circuit.num_qubits
    if config.dtype != "complex64":
        raise ValueError(
            "the segmented sharded engine is float32-only; set "
            "shard_segmented=False for complex128 parity checks")
    axis = config.mesh_axis_names[0]
    d = num_global_qubits(mesh, axis)

    with telemetry.span("qsim/plan"):
        perm = plan_permutation(circuit)
        if np.array_equal(perm, np.arange(n)):
            perm = None

        reorder = getattr(config, "prefetch_reorder", None)
        if reorder is None:
            reorder = True
        precision = resolve_precision(
            getattr(config, "precision", "highest"), n)

        run_key = (
            "shard", _circuit_fingerprint(circuit), precision,
            config.max_fused_qubits, bool(reorder), mesh.key, axis,
        )
        prog = telemetry.lookup(_RUN_CACHE, run_key)
        if prog is None:
            if perm is None:
                work = circuit
                final_layout = np.arange(n)
            else:
                work = circuit.relabeled(perm)
                final_layout = np.argsort(perm)
            ops = _fuse_pipeline(
                work, min(config.max_fused_qubits, LANE_QUBITS), max_high=2,
                window=8)
            cap_mats = 4 if n - d >= 21 else CAP_MATS
            prog = ShardedPrefetchProgram(
                ops, n, mesh, axis, precision=precision, cap_mats=cap_mats,
                final_layout=final_layout, reorder=bool(reorder))
            if len(_RUN_CACHE) >= _RUN_CACHE_LIMIT:
                _RUN_CACHE.pop(next(iter(_RUN_CACHE)))
            _RUN_CACHE[run_key] = prog

    if perm is not None and initial_parts is not None:
        iv = np.asarray(initial_parts[0]) + 1j * np.asarray(initial_parts[1])
        iv = unpermute_state(iv, np.argsort(perm))
        initial_parts = (np.ascontiguousarray(iv.real),
                         np.ascontiguousarray(iv.imag))

    re, im = prog.init_state(initial_parts)
    re, im = prog(re, im)
    total = (prog.plan.num_ops + prog.plan.num_tswaps + prog.plan.num_xswaps
             + prog.plan.num_gswaps + prog.plan.num_relayouts)
    # final_layout routed the state back to the original basis in-plan
    return re, im, total, None
