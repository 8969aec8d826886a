"""The benchmark of the PyTorch/CUDA port on one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository's root, on a machine with as many CUDA cards as the
cell asks for (``BENCHMARK.json``).  It builds the port's kernels on first
use into ``build/`` (a fixed directory of the checkout, so a second run finds
them built), makes the cell's circuits from ``--seed``, warms up, measures
for ``--seconds``, checks every answer against the plain reference, and
prints one JSON line last on standard output: the end-to-end metrics with
``--trace 0``, the per-layer metrics and the breakdown of the traced window
with ``--trace 1``.  The numbers compared with the reference, each beside
its limit, are the last lines on standard error and the line's last key.

Without a card it exits with code 2 and prints no result; where JAX or the
JAX package (``gpu_quantum_simulator_tpu``) was loaded by the time the
result is made, it names them and exits with code 1, with no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    # Triton is not on the port's path; should anything reach it, its cache
    # is a fixed directory of the checkout, as the kernel build's is
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    sys.path.insert(0, ROOT)

    from benchmark.harness import Spec, refuse_forbidden, run_cell

    spec = Spec(ROOT)
    chips = int(spec.cell(args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"no result: the cell needs {chips} CUDA card(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
             f"device_count() = {torch.cuda.device_count()}")
        return 2
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, log=_log)
    _log(f"card: {_card_line()}")
    for name, c in checks.items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    refuse_forbidden()          # the last look before the result line
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
