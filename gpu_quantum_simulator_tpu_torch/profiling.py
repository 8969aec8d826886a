"""Where each strategy's main path's time goes, per width.

    python3 -m gpu_quantum_simulator_tpu_torch.profiling [--widths 18 22]
        [--strategy prefetch mxu pallas vmem] [--precision auto]
        [--mono-as-mat auto 0 1] [--runs 5] [--sweep] [--plan-only]
        [--inplace]

Widths 9..30.  For each strategy (prefetch: each mono-lowering arm,
``auto`` the planner's default, ``0``/``1`` forcing the mono step or
mono-as-mat) and each width it plans ``grover_like(n, 2445, 318)`` as the
Simulator does and prints the plan's counts — prefetch: fused ops,
monomial fused ops, entries, steered prologues, relayouts (folded and
standalone), steps by kind; mxu: fused ops by kh, mm steps by D, kh0 runs
and their lengths; pallas: items, mat items, swaps; vmem (n <= 19): fused
ops by D and chunks, one kernel launch each — and the precision rung
"auto" resolves to.  That much runs anywhere (``--plan-only`` stops
there, on the CPU).

On a CUDA card it then runs ``Simulator.run_detailed`` at ``--precision``
("auto" by default; pallas and vmem always run fp32): one warm-up, then
``--runs`` timed runs, each split into the
host's enqueue of the engine, the engine to its sync, and the unpermute
(mxu, pallas, vmem), the copy to the host and the join; kernel launches
per run of every wrapper that counts them, by kind (``telemetry``'s
``launch_counts``: the block kernels' mat, "high" and "default" mat,
gather and pair launches, relayouts, kh0 chains per rung, block128, the
mm steps per rung, vmem chunks, pair swaps, gswaps, ...); and the
amplitude error against the native f64 reference up to n = 23 (above it
the reference is not run: its time grows 2x per qubit; the norm is
reported).  One more run goes under
``torch.profiler``: device busy time (the union of the device events), the
profiled wall time, the device's idle share, and each device event's count
and total time by name.

``--inplace`` profiles prefetch's in-place split-state engine instead
(``prefetch_inplace=True``): the plan's entries by scal mode (2: pair
swaps, 3: in-place relayouts; the packed scal table adds padding rows of
mode 0), and per run the enqueue, the time to the sync and ``norm_halves``
on the four column halves (no copy to the host), launches by kind, the peak
device memory, the error against the f64 reference up to n = 23, and the
profile.  Without it prefetch at n = 30 runs in place all the same (the
default there), through ``run_detailed``, and its plan is counted so.

``--sweep`` also runs prefetch at n = 9..20 at three tile geometries (the
planner's (512, 64) and the shrunken (4, 1) and (16, 2), which put
prologues and relayouts at small n) against the f64 reference.

The last line of the output is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from . import models
from .config import SimulatorConfig, resolve_precision
from .engine import pallas_engine as PE
from .engine import prefetch as PF
from .engine import simulator as S
from .engine import vmem as V
from .engine import wide as W
from .engine.simulator import Simulator, _fuse_pipeline
from . import sampling
from . import telemetry
from .kernels import build
from .kernels.block import run_block
from .kernels.relayout import run_relayout
from .ops.apply import join_state
from .passes.fuse4x4 import fuse_4x4
from .passes.fuse_k import fuse_k
from .passes.permute import plan_permutation
from .passes.shard import plan_sharded
from .ref.native import simulate_native

GATES, SEED = 2445, 318
SWEEP_TILES = ((512, 64), (4, 1), (16, 2))
SWEEP_WIDTHS = range(9, 21)
REF_MAX_QUBITS = 23      # widest run held to the f64 reference


def _arm(text: str):
    return {"auto": None, "0": False, "1": True}[text]


STRATEGIES = ("prefetch", "mxu", "pallas", "vmem")


def _clear_caches() -> None:
    for cache in (PF._PROGRAM_CACHE, PF._RUN_CACHE, S._MXU_PLAN_CACHE,
                  W._CACHE, PE._CACHE, V._CACHE):
        cache.clear()


def _launches() -> dict:
    """Launches by wrapper and kind, of every counting wrapper
    (``telemetry.launch_counts``)."""
    return {k: v for k, v in telemetry.counters().items()
            if k.startswith("launches/")}


def plan_counts(n: int, strategy: str = "prefetch",
                precision: str = "auto", inplace: bool = False) -> dict:
    """The plan the Simulator builds for the benchmark circuit, counted."""
    if inplace:
        return _inplace_counts(n, precision)
    if strategy == "mxu":
        return _mxu_counts(n, precision)
    if strategy == "pallas":
        return _pallas_counts(n)
    if strategy == "vmem":
        return _vmem_counts(n)
    config = SimulatorConfig(strategy="prefetch", precision=precision)
    c = models.grover_like(n, GATES, SEED)
    perm = plan_permutation(c)
    max_high, cap_mats, window = PF.resolve_prefetch_knobs(config, n, False)
    ops = _fuse_pipeline(c.relabeled(perm), PF.LANE_QUBITS,
                         max_high=max_high, window=window)
    plan = PF.plan_circuit(ops, n, cap_mats=cap_mats,
                           final_layout=np.argsort(perm))
    folded = PF._fold_relayout_entries(plan.blocks) \
        if PF.resolve_stream_relayout(n) else plan.blocks
    logt = plan.logt
    kinds = [k for b in plan.blocks for k in b.kinds]
    return {
        "n": n, "precision": resolve_precision(config.precision, n),
        "max_high": max_high, "cap_mats": cap_mats, "window": window,
        "mono_as_mat": plan.mono_as_mat, "fused_ops": len(ops),
        "monomial_ops": sum(PF._monomial_phases(op.u) is not None
                            for op in ops),
        "entries": len(folded),
        "steered": sum(b.prologue is not None for b in plan.blocks),
        "relayouts": plan.num_relayouts,
        "folded_relayouts": sum(b.relayout_pro is not None for b in folded),
        "standalone_relayouts": sum(b.relayout is not None for b in folded),
        "mat_steps": kinds.count(0),
        "mono_steps": kinds.count(logt + 2),
        "perm_steps": kinds.count(logt + 1),
        "tswap_steps": sum(1 <= k <= logt for k in kinds),
        "perm_folds": plan.num_pfolds,
    }


def _inplace_counts(n: int, precision: str) -> dict:
    """The in-place plan (``prefetch_inplace=True``): involutive relayouts,
    prologues hoisted into pair-swap entries, nothing folded."""
    config = SimulatorConfig(strategy="prefetch", precision=precision,
                             prefetch_inplace=True)
    c = models.grover_like(n, GATES, SEED)
    perm = plan_permutation(c)
    max_high, cap_mats, window = PF.resolve_prefetch_knobs(config, n, True)
    ops = _fuse_pipeline(c.relabeled(perm), PF.LANE_QUBITS,
                         max_high=max_high, window=window)
    plan = PF.plan_circuit(ops, n, cap_mats=cap_mats,
                           final_layout=np.argsort(perm),
                           involution_relayout=True)
    entries = PF.hoist_prologues(plan.blocks)
    logt = plan.logt
    kinds = [k for b in plan.blocks for k in b.kinds]
    return {
        "n": n, "inplace": True,
        "precision": resolve_precision(config.precision, n),
        "max_high": max_high, "cap_mats": cap_mats, "window": window,
        "mono_as_mat": plan.mono_as_mat, "fused_ops": len(ops),
        "entries": len(entries),
        "entries_by_mode": {
            0: sum(b.prologue is None and b.relayout is None for b in entries),
            2: sum(b.prologue is not None for b in entries),
            3: sum(b.relayout is not None for b in entries)},
        "mat_steps": kinds.count(0),
        "mono_steps": kinds.count(logt + 2),
        "perm_steps": kinds.count(logt + 1),
        "tswap_steps": sum(1 <= k <= logt for k in kinds),
        "perm_folds": plan.num_pfolds,
    }


def _mxu_counts(n: int, precision: str) -> dict:
    """The mxu engine's fused ops by kh and its step list, without tables."""
    config = SimulatorConfig(strategy="mxu", precision=precision)
    c = models.grover_like(n, GATES, SEED)
    ops = _fuse_pipeline(c.relabeled(plan_permutation(c)),
                         config.max_fused_qubits, max_high=2, window=8,
                         cost_model=True)
    steps = [st for seg in W.plan_segments(ops, n) for st in seg[0]]
    kh = [sum(q >= W.LANE_QUBITS for q in op.qubits) for op in ops]
    return {
        "n": n, "precision": resolve_precision(config.precision, n),
        "fused_ops": len(ops), "ops_by_kh": {k: kh.count(k) for k in (0, 1, 2)},
        "mm_steps_by_D": {d: sum(st[0] == "mm" and st[1] == d for st in steps)
                          for d in (128, 256, 512)},
        "kh0_runs": [st[2] for st in steps if st[0] == "kh0"],
    }


def _pallas_counts(n: int) -> dict:
    """The pallas engine's low-region plan, counted."""
    c = models.grover_like(n, GATES, SEED)
    ops = fuse_k(fuse_4x4(c.relabeled(plan_permutation(c))),
                 max_qubits=W.LANE_QUBITS)
    plan = plan_sharded(ops, n, n - W.LANE_QUBITS)
    return {"n": n, "fused_ops": len(ops), "items": len(plan.items),
            "mat_items": len(plan.items) - plan.num_swaps,
            "swaps": plan.num_swaps}


def _vmem_counts(n: int) -> dict:
    """The vmem engine's fused ops by D and its chunks, without tables."""
    c = models.grover_like(n, GATES, SEED)
    ops = _fuse_pipeline(c.relabeled(plan_permutation(c)), W.LANE_QUBITS,
                         max_high=2)
    by_d = [W.LANES << sum(q >= W.LANE_QUBITS for q in op.qubits)
            for op in ops]
    return {"n": n, "fused_ops": len(ops),
            "ops_by_D": {d: by_d.count(d) for d in (128, 256, 512)},
            "chunks": -(-len(ops) // V.CHUNK_OPS)}


def _device_profile(run) -> dict:
    """One call of ``run`` under torch.profiler; device events by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return {"wall_ms": wall_ms, "device_busy_ms": None,
                "idle_share": None, "by_name": {}}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: dict = {}
    for e in events:
        cnt, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, tot + e.time_range.elapsed_us() / 1e3)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "by_name": {k: {"count": v[0], "ms": v[1]} for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1][1])}}


def run_width(n: int, runs: int, strategy: str = "prefetch",
              precision: str = "auto") -> dict:
    """Timed runs, their host/device split, launches, error, a profile."""
    sim = Simulator(SimulatorConfig(strategy=strategy, precision=precision),
                    device="cuda")
    c = models.grover_like(n, GATES, SEED)
    warm = sim.run_detailed(c).seconds
    secs = [sim.run_detailed(c).seconds for _ in range(runs)]
    split = {"enqueue_ms": [], "to_sync_ms": [], "d2h_join_ms": []}
    telemetry.reset()
    work, perm, _ = sim._relabel(c)
    for _ in range(runs):
        t0 = time.perf_counter()
        re, im, _, residual = sim._execute(work)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = join_state(*sim._restore(re, im, perm, residual))
        t3 = time.perf_counter()
        split["enqueue_ms"].append((t1 - t0) * 1e3)
        split["to_sync_ms"].append((t2 - t0) * 1e3)
        split["d2h_join_ms"].append((t3 - t2) * 1e3)
    launches = {k: v // runs for k, v in _launches().items()}
    err = (float(np.max(np.abs(state - simulate_native(c))))
           if n <= REF_MAX_QUBITS else None)
    return {"n": n, "warmup_s": warm, "median_s": statistics.median(secs),
            "runs_s": secs,
            **{k: statistics.median(v) for k, v in split.items()},
            "launches_per_run": launches, "max_abs_err_f64": err,
            "norm": float(np.linalg.norm(state)),
            "profile": _device_profile(lambda: sim.run_detailed(c))}


def run_width_inplace(n: int, runs: int, precision: str = "auto") -> dict:
    """The in-place engine through ``run_device_halves``: timed runs, their
    split (enqueue, to the sync, ``norm_halves``), launches by kind, peak
    device memory, the error up to n = 23, a profile."""
    cfg = SimulatorConfig(strategy="prefetch", precision=precision,
                          prefetch_inplace=True)
    sim = Simulator(cfg, device="cuda")
    c = models.grover_like(n, GATES, SEED)
    t0 = time.perf_counter()
    sim.run_device_halves(c)
    warm = time.perf_counter() - t0
    split_ms = {"enqueue_ms": [], "to_sync_ms": [], "norm_ms": []}
    secs = []
    telemetry.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    parts = None
    for _ in range(runs):
        del parts              # one state on the card at a time
        t0 = time.perf_counter()
        parts, _, _, _ = PF.run_prefetch(c, cfg, sim.device,
                                         return_halves=True)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        norm = sampling.norm_halves(*parts)
        t3 = time.perf_counter()
        secs.append(t2 - t0)
        split_ms["enqueue_ms"].append((t1 - t0) * 1e3)
        split_ms["to_sync_ms"].append((t2 - t0) * 1e3)
        split_ms["norm_ms"].append((t3 - t2) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v // runs for k, v in _launches().items()}
    err = None
    if n <= REF_MAX_QUBITS:
        state = join_state(*PF.join_halves(*parts))
        err = float(np.max(np.abs(state - simulate_native(c))))
    del parts
    (prog,) = PF._RUN_CACHE.values()
    return {"n": n, "warmup_s": warm, "median_s": statistics.median(secs),
            "runs_s": secs,
            **{k: statistics.median(v) for k, v in split_ms.items()},
            "launches_per_run": launches, "max_abs_err_f64": err,
            "norm": norm ** 0.5, "peak_bytes": peak,
            "state_bytes": 8 << n, "scal_rows_by_mode": dict(prog.mode_rows),
            "profile": _device_profile(lambda: sim.run_device_halves(c))}


def sweep() -> list:
    """Widths 9..20 at three tile geometries against the f64 reference."""
    sim = Simulator(SimulatorConfig(strategy="prefetch"), device="cuda")
    saved = PF.TILE_ROWS, PF.RELAYOUT_TILE_ROWS
    out = []
    try:
        for t, tr in SWEEP_TILES:
            PF.TILE_ROWS, PF.RELAYOUT_TILE_ROWS = t, tr
            _clear_caches()
            for n in SWEEP_WIDTHS:
                c = models.grover_like(n, 40 * n, n)
                telemetry.reset()
                got = sim.run(c)
                err = float(np.max(np.abs(got - simulate_native(c))))
                rec = {"tiles": [t, tr], "n": n, "max_abs_err_f64": err,
                       "block": sum(run_block.launches.values()),
                       "relayout": run_relayout.launches}
                print(f"sweep tiles ({t}, {tr}) n={n}: max|cuda - f64| "
                      f"{err:.3e}, launches block {rec['block']} relayout "
                      f"{rec['relayout']}")
                out.append(rec)
    finally:
        PF.TILE_ROWS, PF.RELAYOUT_TILE_ROWS = saved
        _clear_caches()
    return out


def _print_width(rec: dict) -> None:
    p = rec["profile"]
    last = (f"D2H+join {rec['d2h_join_ms']:.2f} ms" if "d2h_join_ms" in rec
            else f"norm_halves {rec['norm_ms']:.2f} ms; peak device memory "
            f"{rec['peak_bytes'] / 2 ** 30:.3f} GiB for a state of "
            f"{rec['state_bytes'] / 2 ** 30:.3f} GiB; scal rows by mode "
            f"{rec['scal_rows_by_mode']}")
    what = "run_detailed" if "d2h_join_ms" in rec else "run_device_halves"
    print(f"  {what} median {rec['median_s'] * 1e3:.2f} ms (runs "
          f"{[round(s * 1e3, 2) for s in rec['runs_s']]} ms, warm-up "
          f"{rec['warmup_s']:.4f} s); enqueue {rec['enqueue_ms']:.2f} ms, to "
          f"sync {rec['to_sync_ms']:.2f} ms, {last}; launches/run "
          f"{rec['launches_per_run']}; max|amp - f64| "
          + ("not measured" if rec["max_abs_err_f64"] is None
             else f"{rec['max_abs_err_f64']:.3e}") + f"; norm {rec['norm']:.8f}")
    if p["device_busy_ms"] is None:
        print("  profile: no device events seen; device busy not measured")
        return
    print(f"  profiled wall {p['wall_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}")
    for name, v in p["by_name"].items():
        print(f"    {v['count']:6d} x {v['ms']:10.3f} ms  {name[:70]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[18, 22],
                    choices=range(PF.MIN_QUBITS, PF.MAX_QUBITS + 1),
                    metavar="N")
    ap.add_argument("--strategy", nargs="+", default=["prefetch"],
                    choices=STRATEGIES)
    ap.add_argument("--precision", default="auto",
                    choices=["auto", "highest", "high"])
    ap.add_argument("--mono-as-mat", nargs="+", default=["auto"],
                    choices=["auto", "0", "1"])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--plan-only", action="store_true")
    ap.add_argument("--inplace", action="store_true",
                    help="prefetch's in-place split-state engine")
    args = ap.parse_args(argv)
    if args.inplace and args.strategy != ["prefetch"]:
        ap.error("--inplace profiles the prefetch strategy")
    if not args.plan_only and not torch.cuda.is_available():
        print("profiling: no CUDA card; pass --plan-only to count plans",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"arms": []}
    if not args.plan_only:
        import subprocess

        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        print(report["card"])
        build.load()       # keep the kernels' build out of the warm-up
    saved = PF.MONO_AS_MAT
    try:
        for strategy in args.strategy:
            # the mono-lowering arms are the prefetch planner's
            arms = args.mono_as_mat if strategy == "prefetch" else ["auto"]
            for arm in arms:
                PF.MONO_AS_MAT = _arm(arm)
                _clear_caches()
                for n in args.widths:
                    # prefetch's default at its ceiling is the in-place plan
                    inplace = args.inplace or (strategy == "prefetch"
                                               and n >= PF.MAX_QUBITS)
                    rec = {"strategy": strategy, "mono_as_mat_arm": arm,
                           "plan": plan_counts(n, strategy, args.precision,
                                               inplace)}
                    print(f"{strategy} arm {arm} n={n} plan: "
                          f"{json.dumps(rec['plan'])}")
                    if not args.plan_only:
                        rec.update(
                            run_width_inplace(n, args.runs, args.precision)
                            if args.inplace else
                            run_width(n, args.runs, strategy, args.precision))
                        _print_width(rec)
                        _clear_caches()  # free the width's device tables
                        torch.cuda.empty_cache()
                    report["arms"].append(rec)
    finally:
        PF.MONO_AS_MAT = saved
        _clear_caches()
    if args.sweep and not args.plan_only:
        report["sweep"] = sweep()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
