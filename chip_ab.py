#!/usr/bin/env python3
"""Compare checkouts of the port on one CUDA card, in turns.

    python3 chip_ab.py --trees ab/parent . . ab/parent \\
        [--phases sass mat high highdrift split chain chaindrift vmem mm \\
                  drift mxupeak pergate workloads] \\
        [--profile "--strategy mxu --widths 24"] \\
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
  workloads  time_workloads: the workloads on the state — adjoint_gradient
         on the default config at n=24 (seconds, peak reserved), run_vqe's
         40 steps at n=20 (ms a step), the n + s = 28 trajectory ensemble
         (GHZ-20, 256 shots) and a per-gate noisy one with the segments'
         pair handed over and copied (the copies' share)
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
}
FUNCS = {"mat": "check_block_kernel", "high": "check_high_mat",
         "highdrift": "check_high_drift", "split": "check_split_block",
         "folded": "check_folded_block",
         "chain": "check_wide_chain", "chaindrift": "check_chain_drift",
         "vmem": "check_vmem_kernel", "mm": "check_mm_high",
         "drift": "mxu_high_drift", "streams": "check_two_streams",
         "sass": "check_high_sass", "mxupeak": None,
         "pergate": "time_ablation", "workloads": "time_workloads"}
ECHO = ("mat step n=", "split mat step n=", "at the end kernel", "vmem one op",
        "vmem chunk kernel", "mm step high", "over seeds", "run_detailed",
        "busy", "NVIDIA", "kernels built", "mxu peak", "sass ",
        "two streams", "ptxas", "chain kernel n=", "apply_block128 n=",
        "ablation n=", "workloads ")

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


for name, call in {calls!r}:
    if name is not None and not hasattr(C, name):
        print("phase", name, "absent in this tree")
        continue
    eval(call)
    torch.cuda.synchronize()
"""


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
