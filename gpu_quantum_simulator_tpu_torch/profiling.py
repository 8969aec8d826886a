"""Where the prefetch main path's time goes, per width.

    python3 -m gpu_quantum_simulator_tpu_torch.profiling [--widths 18 22]
        [--mono-as-mat auto 0 1] [--runs 5] [--sweep] [--plan-only]

For each mono-lowering arm (``auto`` is the planner's default; ``0``/``1``
force the mono step or mono-as-mat) and each width it plans
``grover_like(n, 2445, 318)`` and prints the plan's counts: fused ops,
monomial fused ops, entries, steered prologues, relayouts and steps by kind.
That much runs anywhere (``--plan-only`` stops there, on the CPU).

On a CUDA card it then runs ``Simulator.run_detailed``: one warm-up, then
``--runs`` timed runs, each split into the host's enqueue of the chain,
the chain to its sync, and the copy to the host plus the join; kernel
launches per run; and the amplitude error against the native f64
reference.  One more run goes under ``torch.profiler``: device busy time
(the union of the device events), the profiled wall time, the device's
idle share, and each device event's count and total time by name.

``--sweep`` also runs n = 9..20 at three tile geometries (the planner's
(512, 64) and the shrunken (4, 1) and (16, 2), which put prologues and
relayouts at small n) against the f64 reference.

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
from .config import SimulatorConfig
from .engine import prefetch as PF
from .engine.simulator import Simulator, _fuse_pipeline
from .kernels.block import run_block
from .kernels.relayout import run_relayout
from .ops.apply import join_state
from .passes.permute import plan_permutation
from .ref.native import simulate_native

GATES, SEED = 2445, 318
SWEEP_TILES = ((512, 64), (4, 1), (16, 2))
SWEEP_WIDTHS = range(9, 21)


def _arm(text: str):
    return {"auto": None, "0": False, "1": True}[text]


def _clear_caches() -> None:
    PF._PROGRAM_CACHE.clear()
    PF._RUN_CACHE.clear()


def plan_counts(n: int) -> dict:
    """The plan the Simulator builds for the benchmark circuit, counted."""
    config = SimulatorConfig(strategy="prefetch")
    c = models.grover_like(n, GATES, SEED)
    perm = plan_permutation(c)
    max_high, cap_mats, window = PF.resolve_prefetch_knobs(config, n, False)
    ops = _fuse_pipeline(c.relabeled(perm), PF.LANE_QUBITS,
                         max_high=max_high, window=window)
    plan = PF.plan_prefetch(ops, n, cap_mats=cap_mats,
                            final_layout=np.argsort(perm))
    logt = plan.logt
    kinds = [k for b in plan.blocks for k in b.kinds]
    return {
        "n": n, "max_high": max_high, "cap_mats": cap_mats, "window": window,
        "mono_as_mat": plan.mono_as_mat, "fused_ops": len(ops),
        "monomial_ops": sum(PF._monomial_phases(op.u) is not None
                            for op in ops),
        "entries": len(plan.blocks),
        "steered": sum(b.prologue is not None for b in plan.blocks),
        "relayouts": plan.num_relayouts,
        "mat_steps": kinds.count(0),
        "mono_steps": kinds.count(logt + 2),
        "perm_steps": kinds.count(logt + 1),
        "tswap_steps": sum(1 <= k <= logt for k in kinds),
        "perm_folds": plan.num_pfolds,
    }


def _device_profile(sim, c) -> dict:
    """One run_detailed under torch.profiler; device events by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run_detailed(c)
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


def run_width(n: int, runs: int) -> dict:
    """Timed runs, their host/device split, launches, error, a profile."""
    config = SimulatorConfig(strategy="prefetch")
    sim = Simulator(config, device="cuda")
    c = models.grover_like(n, GATES, SEED)
    warm = sim.run_detailed(c).seconds
    secs = [sim.run_detailed(c).seconds for _ in range(runs)]
    split = {"enqueue_ms": [], "to_sync_ms": [], "d2h_join_ms": []}
    run_block.launches = run_relayout.launches = 0
    for _ in range(runs):
        t0 = time.perf_counter()
        re, im, _, _ = PF.run_prefetch(c, config, torch.device("cuda"))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = join_state(re, im)
        t3 = time.perf_counter()
        split["enqueue_ms"].append((t1 - t0) * 1e3)
        split["to_sync_ms"].append((t2 - t0) * 1e3)
        split["d2h_join_ms"].append((t3 - t2) * 1e3)
    launches = {"block": run_block.launches // runs,
                "relayout": run_relayout.launches // runs}
    err = float(np.max(np.abs(state - simulate_native(c))))
    return {"n": n, "warmup_s": warm, "median_s": statistics.median(secs),
            "runs_s": secs,
            **{k: statistics.median(v) for k, v in split.items()},
            "launches_per_run": launches, "max_abs_err_f64": err,
            "norm": float(np.linalg.norm(state)),
            "profile": _device_profile(sim, c)}


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
                run_block.launches = run_relayout.launches = 0
                got = sim.run(c)
                err = float(np.max(np.abs(got - simulate_native(c))))
                rec = {"tiles": [t, tr], "n": n, "max_abs_err_f64": err,
                       "block": run_block.launches,
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
    print(f"  run_detailed median {rec['median_s'] * 1e3:.2f} ms (runs "
          f"{[round(s * 1e3, 2) for s in rec['runs_s']]} ms, warm-up "
          f"{rec['warmup_s']:.4f} s); enqueue {rec['enqueue_ms']:.2f} ms, to "
          f"sync {rec['to_sync_ms']:.2f} ms, D2H+join {rec['d2h_join_ms']:.2f}"
          f" ms; launches/run {rec['launches_per_run']}; max|amp - f64| "
          f"{rec['max_abs_err_f64']:.3e}")
    if p["device_busy_ms"] is None:
        print("  profile: no device events seen; device busy not measured")
        return
    print(f"  profiled wall {p['wall_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}")
    for name, v in p["by_name"].items():
        print(f"    {v['count']:6d} x {v['ms']:10.3f} ms  {name[:70]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[18, 22])
    ap.add_argument("--mono-as-mat", nargs="+", default=["auto"],
                    choices=["auto", "0", "1"])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--plan-only", action="store_true")
    args = ap.parse_args(argv)
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
        from .kernels import build

        build.load()       # keep the kernels' build out of the warm-up
    saved = PF.MONO_AS_MAT
    try:
        for arm in args.mono_as_mat:
            PF.MONO_AS_MAT = _arm(arm)
            _clear_caches()
            for n in args.widths:
                rec = {"mono_as_mat_arm": arm, "plan": plan_counts(n)}
                print(f"arm {arm} n={n} plan: {json.dumps(rec['plan'])}")
                if not args.plan_only:
                    rec.update(run_width(n, args.runs))
                    _print_width(rec)
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
