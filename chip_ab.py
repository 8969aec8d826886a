#!/usr/bin/env python3
"""Compare checkouts of the port on one CUDA card, in turns.

    python3 chip_ab.py --trees ab/parent . . ab/parent \\
        [--phases sass mat high highdrift split chain chaindrift vmem mm \\
                  drift mxupeak pergate workloads defmat defmm defchain \\
                  defdrift defsteps defpaths lowonly copy] \\
        [--profile "--strategy mxu --widths 24"] \\
        [--strip adds|wgmmas] \\
        [--out chiprun_out/ab]

For each tree, in the order given (name a tree twice to run it twice, as
in parent, change, change, parent), one process imports that tree's
``chip_smoke.py`` and runs the named kernel phases that it has, then each
``--profile`` argument string runs that tree's
``python3 -m gpu_quantum_simulator_tpu_torch.profiling`` in a process of
its own.  Every tree builds its kernels into its own ``build/``.  Each
tree's output goes to ``<out>_<i>_<tree name>.txt``; the lines that carry
a kernel time or a run time are echoed.  Exits non-zero when a process
fails.

Phases (chip_smoke function, where the tree has it):
  mat    check_block_kernel: the block kernel and the fp32 mat step, n=22
  high   check_high_mat: the flat "high" mat step, n=24 and 28
  highdrift  check_high_drift: the "high" mat step's norm drift, n=24
  split  check_split_block: the in-place mat steps beside the flat ones, n=24
  folded check_folded_block: the folded-relayout input (mat first), n=24
  chain  check_wide_chain: kernel 7's chain (P = 1 and 8, both rungs) and
         kernel 9, n=24
  chaindrift  check_chain_drift: the "high" chain's norm drift, n=24
  vmem   check_vmem_kernel: kernel 8's chunk and one D=512 op, n=18
  mm     check_mm_high: the mxu "high" mm step, n=24, D = 512 and 256
  drift  mxu_high_drift: the mxu "high" mm step's norm drift, n=24
  streams  check_two_streams: in-place "high" steps on two streams, n=24
  sass   check_high_sass: HGMMA in the "high" kernels' SASS
  mxupeak  (this script's own) peak device memory of the default config
         (mxu, "auto") on grover_like at n = 24 and 28: one warm-up run,
         then one run_detailed after reset_peak_memory_stats
  pergate  time_ablation: the reference's ablation rows at n=18 through
         the CLI (naive, fused2x2, fused3in1, fused4x4, scan, megakernel,
         mxu, prefetch; the CLI's seconds, median of 3 after a warm-up)
  defmat check_default_mat: the "default" mat step flat (n=24, 28) and in
         place (n=24, 30) beside its "high" arm, plain version, one bf16
         torch.mm and bound
  defmm  check_default_mm: the mxu "default" mm step, n=24, D = 512 and 256
  defchain  check_default_chain: kernel 7's "default" chain, n=24, P = 1
         and 8 (beside its "high" arm, plain version, library and bound)
  defdrift  check_high_drift(torch, "default"): the "default" mat step's
         norm drift, n=24
  defsteps  (this script's own) the "default" mat step flat and in place
         and the mm step at D = 512 and 256, n=24, timed alone (no check:
         with --strip the values are wrong by design)
  defpaths  (this script's own) the Simulator at "default" on grover_like:
         prefetch flat and mxu at n=24 (run_detailed, median of 3 after a
         warm-up) and prefetch in place at n=30 (run_device_halves to a
         sync, median of 2 after a warm-up)
  lowonly  (this script's own) mxu at "default" on chip_smoke's low-only
         circuit (LOW_ONLY, n=24) at max_fused_qubits 3, the path that
         launches kernel 7's "default" chain: run_detailed, median of 5
         after a warm-up, and the chain launches of one run
  copy   check_copy_probes: kernel 11's three routes at n = 24, 28, 30
         beside copy_ (GB/s, and each route's fastest as a ratio)
  workloads  time_workloads: the workloads on the state — adjoint_gradient
         on the default config at n=24 (seconds, peak reserved), run_vqe's
         40 steps at n=20 (ms a step), the n + s = 28 trajectory ensemble
         (GHZ-20, 256 shots) and a per-gate noisy one with the segments'
         pair handed over and copied (the copies' share)

--strip adds|wgmmas runs each tree from a copy under build/ whose
"default" mat and mm k-loops lack their partials' fp32 adds, or their
wgmmas: with defsteps, what each side of the overlap takes alone.  A
diagnostic tied to the exact text of those k-loop lines (STRIP's regexes):
it exits when a pattern matches another number of times than STRIP says,
so an edit to those lines has to update STRIP.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

PHASES = {
    "mat": "C.check_block_kernel(torch, rng)",
    "high": "C.check_high_mat(torch, rng)",
    "highdrift": "C.check_high_drift(torch)",
    "split": "C.check_split_block(torch, rng)",
    "folded": "C.check_folded_block(torch, rng)",
    "chain": "C.check_wide_chain(torch, rng)",
    "chaindrift": "C.check_chain_drift(torch)",
    "vmem": "C.check_vmem_kernel(torch, T)",
    "mm": "C.check_mm_high(torch)",
    "drift": "C.mxu_high_drift(torch)",
    "streams": "C.check_two_streams(torch)",
    "sass": "C.check_high_sass()",
    "mxupeak": "mxu_peak((24, 28))",
    "pergate": "C.time_ablation(torch, T)",
    "workloads": "C.time_workloads(torch, T)",
    "defmat": "C.check_default_mat(torch)",
    "defmm": "C.check_default_mm(torch)",
    "defchain": "C.check_default_chain(torch)",
    "defdrift": "C.check_high_drift(torch, 'default')",
    "defsteps": "default_steps()",
    "defpaths": "default_paths()",
    "lowonly": "low_only_default()",
    "copy": "C.check_copy_probes(torch, lambda counts: None)",
}
FUNCS = {"mat": "check_block_kernel", "high": "check_high_mat",
         "highdrift": "check_high_drift", "split": "check_split_block",
         "folded": "check_folded_block",
         "chain": "check_wide_chain", "chaindrift": "check_chain_drift",
         "vmem": "check_vmem_kernel", "mm": "check_mm_high",
         "drift": "mxu_high_drift", "streams": "check_two_streams",
         "sass": "check_high_sass", "mxupeak": None,
         "pergate": "time_ablation", "workloads": "time_workloads",
         "defmat": "check_default_mat", "defmm": "check_default_mm",
         "defchain": "check_default_chain", "defdrift": "check_high_drift",
         "defsteps": None, "defpaths": None, "lowonly": None,
         "copy": "check_copy_probes"}
ECHO = ("mat step n=", "split mat step n=", "at the end kernel", "vmem one op",
        "vmem chunk kernel", "mm step high", "over seeds", "run_detailed",
        "busy", "NVIDIA", "kernels built", "mxu peak", "sass ",
        "two streams", "ptxas", "chain kernel n=", "apply_block128 n=",
        "ablation n=", "workloads ", "default ", "stripped", "copy probe",
        "low-only")

PHASE_RUN = """
import sys, numpy as np, torch
sys.path.insert(0, {tree!r})
import chip_smoke as C
import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.manual_seed(2445)
build.load()
print("kernels built" + ("" if build.last_build is None else
      " in %.1f s" % build.last_build["seconds"]))
if build.last_build:
    for line in build.last_build["log"].splitlines():
        if ("registers" in line or "spill" in line or "wgmma" in line
                or "Compiling" in line):
            print("  ptxas:", line.strip())
rng = np.random.default_rng(2445)


def mxu_peak(widths):
    for n in widths:
        sim = T.Simulator(T.SimulatorConfig(strategy="mxu"), device="cuda")
        c = T.models.grover_like(n, 2445, 318)
        sim.run_detailed(c)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs = sim.run_detailed(c).seconds
        peak = torch.cuda.max_memory_allocated()
        print("mxu peak n=%d: %.3f GiB peak device memory in run_detailed "
              "(%.4f s), %.3f GiB held before it (program tables), state "
              "pair %.3f GiB" % (n, peak / 2 ** 30, secs, held / 2 ** 30,
                                 2 ** (n + 3) / 2 ** 30))
        del sim
        C.clear_caches(torch)


def default_steps(n=24):
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, split_tables)
    from gpu_quantum_simulator_tpu_torch.kernels.split import (
        run_split_block)

    blk = PF._Block(kinds=[0], midx=[0], mats=[
        (C.random_unitary(rng, 128), tuple(range(7)), None)])
    scal, a, b, mono = C.device_tables(torch, PF, [blk], 2)
    w = split_tables(a, b)
    R2 = 1 << (n - 8)
    args = (a[0], b[0], mono[0], int(np.log2(PF.tile_rows(n))),
            PF.CAP_STEPS)
    re, im = (torch.randn(R2, 256, device="cuda") / 16 for _ in range(2))
    spare = (torch.empty_like(re), torch.empty_like(im))
    ms = {{"mat flat": C.device_ms(torch, lambda: run_block(
        scal[0], re, im, *args, scratch=spare, precision="default",
        high_tables=w[0]))}}
    h4 = (re[:, :128].contiguous(), re[:, 128:].contiguous(),
          im[:, :128].contiguous(), im[:, 128:].contiguous())
    ms["mat in place"] = C.device_ms(torch, lambda: run_split_block(
        scal[0], h4, *args, precision="default", high_tables=w[0]))
    x = (re.reshape(-1, 128), im.reshape(-1, 128))
    out = (torch.empty_like(x[0]), torch.empty_like(x[1]))
    for bits in ((0, 1), (0,)):
        D = 128 << len(bits)
        w16 = KW.split_mm_tables_hi(C.mm_unitary_tables(torch, rng, D, 1)[0])
        ms[f"mm D={{D}}"] = C.device_ms(torch, lambda: KW.mm_step_default(
            *x, w16, bits, out=out), reps=10)
    print("default steps n=%d: " % n + ", ".join(
        "%s %.4f ms" % kv for kv in ms.items()))


def default_paths():
    import statistics
    import time

    def sim(strategy):
        return T.Simulator(T.SimulatorConfig(strategy=strategy,
                                             precision="default"),
                           device="cuda")

    for strategy in ("prefetch", "mxu"):
        s, c = sim(strategy), T.models.grover_like(24, 2445, 318)
        s.run_detailed(c)
        secs = [s.run_detailed(c).seconds for _ in range(3)]
        print("default path %s n=24: run_detailed %.4f s (median of %s)"
              % (strategy, statistics.median(secs),
                 ", ".join("%.4f" % x for x in secs)))
        del s
        C.clear_caches(torch)
    s, c = sim("prefetch"), T.models.grover_like(30, 2445, 318)
    secs = []
    for run in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, _ = s.run_device_halves(c)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del parts
    print("default path prefetch in place n=30: run_device_halves %.4f s "
          "(median of %s after a first run of %.4f s)"
          % (statistics.median(secs[1:]),
             ", ".join("%.4f" % x for x in secs[1:]), secs[0]))
    del s
    C.clear_caches(torch)


def low_only_default():
    import statistics

    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW

    n, gates, seed = C.LOW_ONLY
    c = C.low_only(T, n, gates, seed)
    sim = T.Simulator(T.SimulatorConfig(strategy="mxu", precision="default",
                                        max_fused_qubits=3), device="cuda")
    sim.run_detailed(c)
    KW.reset_launches()
    runs = [sim.run_detailed(c) for _ in range(5)]
    secs = [r.seconds for r in runs]
    chains = KW.kh0_chain.launches["default"] // 5
    ref = T.Simulator(T.SimulatorConfig(strategy="mxu", precision="highest",
                                        max_fused_qubits=3),
                      device="cuda").run(c)
    print("default low-only mxu n=%d: run_detailed %.4f s (median of %s), "
          "%d chain launches a run, max|amp - 'highest'| %.3e"
          % (n, statistics.median(secs), ", ".join("%.4f" % x for x in secs),
             chains, float(np.max(np.abs(runs[-1].state - ref)))))
    del sim, runs
    C.clear_caches(torch)


for name, call in {calls!r}:
    if name is not None and not hasattr(C, name):
        print("phase", name, "absent in this tree")
        continue
    eval(call)
    torch.cuda.synchronize()
"""


# --strip: (file, pattern, replacement, matches) edits of a tree's copy
STRIP = {
    "adds": [("wgmma_high.cuh",
              r"sre\[e\] = \(sre\[e\] \+ d0\[e\]\) - d1\[e\];", ";", 1),
             ("wgmma_high.cuh",
              r"sim\[e\] = \(sim\[e\] \+ d0\[e\]\) \+ d1\[e\];", ";", 1),
             ("mm_high.cu", r"kh::add1\(T\[P\], (X\[P\]\[[01]\])\);",
              r"kh::pin(\1);", 2)],
    "wgmmas": [("wgmma_high.cuh", r"bf16<1>\((pa|pb|pc|pd), [^;]*\);", "", 8),
               ("karatsuba_high.cuh", r"mma\(x\[[01]\], h[01], mh, 0\);",
                "", 2)],
}


def stripped(tree, what, i):
    """A copy of the tree's port package and chip_smoke.py under build/
    with the "default" k-loops' ``what`` removed (STRIP)."""
    import re
    import shutil

    dst = os.path.abspath(f"build/strip_{i}_{what}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "gpu_quantum_simulator_tpu_torch"),
                    os.path.join(dst, "gpu_quantum_simulator_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tree, "chip_smoke.py"), dst)
    csrc = os.path.join(dst, "gpu_quantum_simulator_tpu_torch", "csrc")
    for name, pat, rep, count in STRIP[what]:
        path = os.path.join(csrc, name)
        text, n = re.subn(pat, rep, open(path).read())
        if n != count:
            raise SystemExit(f"--strip {what}: {n} matches of {pat!r} in "
                             f"{name}, expected {count}")
        with open(path, "w") as f:
            f.write(text)
    return dst


def run(cmd, cwd, log, env):
    with open(log, "a") as f:
        f.write("$ " + " ".join(cmd) + "\n")
        f.flush()
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        for line in proc.stdout:
            f.write(line)
            if any(k in line for k in ECHO):
                print("   ", line.rstrip())
        return proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--phases", nargs="*", default=[], choices=sorted(PHASES))
    ap.add_argument("--profile", action="append", default=[],
                    help="arguments of one profiling.py run (repeatable)")
    ap.add_argument("--strip", choices=sorted(STRIP))
    ap.add_argument("--out", default="chiprun_out/ab")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = []
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        name = os.path.basename(tree.rstrip("/")) or "tree"
        if args.strip:
            tree = stripped(tree, args.strip, i + 1)
            print(f"   stripped of the 'default' k-loops' {args.strip}: "
                  f"{tree}")
        log = os.path.abspath(f"{args.out}_{i + 1}_{name}.txt")
        print(f"== {i + 1}: {tree} -> {log}")
        with open(log, "w") as f:
            f.write(smi + "\n")
        env = dict(os.environ, PYTHONPATH=tree)
        if args.phases:
            calls = [(FUNCS[p], PHASES[p]) for p in args.phases]
            code = PHASE_RUN.format(tree=tree, calls=calls)
            if run([sys.executable, "-c", code], tree, log, env):
                failed.append(f"{name} phases")
        for prof in args.profile:
            cmd = [sys.executable, "-m",
                   "gpu_quantum_simulator_tpu_torch.profiling", *prof.split()]
            if run(cmd, tree, log, env):
                failed.append(f"{name} profiling {prof}")
    if failed:
        print("failed:", failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
