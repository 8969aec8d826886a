"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--control]

For each seed, in one process: the cell's traffic for that seed and one
request of its window, through the same entry, sizes and capture as a run
of ``run.py`` (one warm-up request comes first, for the first seed), then
the numbers ``correct`` compares, each beside its limit, one JSON line a
seed.  ``--control`` runs the program with the
configuration's ``control`` settings (the rung below the one it states).
``run.py`` never runs this; it is how the lower and upper readings of each
limit in ``PERF.md`` were taken.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device="cuda", root=ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark.harness import Cell, Spec

    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = Spec(root)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = Cell(spec, args.workload, seed, device)
        if args.control:
            cell = Cell(spec, args.workload, seed, device,
                        cell.config["control"])
        capture = cell.capture()
        capture.deadline = -float("inf")      # keep every request's state
        with capture.installed():
            if seed == args.seeds[0]:
                cell.call(cell.warm, 0)    # the kernels load once a process
            t1 = time.perf_counter()
            answer = cell.call(cell.circuits[0], 0)
            t2 = time.perf_counter()
        kept = capture.state
        cell.sim = capture = None
        checks, failed = cell.judge([answer], kept)
        del kept, answer
        if device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "failed": failed,
                          "request_s": t2 - t1, "seed_s":
                          time.perf_counter() - t0, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
