"""The least time a hand kernel's launch could take on the card.

Peaks are NVIDIA's published figures for one H100 SXM, dense: 989 TFLOP/s
in bf16 on the tensor cores, 67 TFLOP/s in float32 on the CUDA cores, 3.35
TB/s of HBM, at the full 700 W (a run prints the card's power limit beside
its shares).  A launch's least time is the larger of its least operations
over the peak rate and its least bytes over the HBM rate, as
``chip_smoke.py``'s ``bound`` counts them for the main path's kernels:

- a fused D x D complex matrix applied to the 2^n-amplitude state is three
  real products (Karatsuba), 2 * 2^n * D operations each; at "high" each
  product is three bf16 passes, at "default" one, at "highest" one float32
  product on the CUDA cores;
- every launch reads and writes the share of the state pair that it must
  move, 16 bytes an amplitude (re and im, float32, read once and written
  once).  Tables are left out: the least time stays a lower bound.

Which launch is which comes from the kernel table: one JSON file a kernel
under ``kernels/``, found by the kernel's name (see ``KernelTable``).  A
hand kernel that no file names counts with the whole state's bytes and is
reported by name, so that a later change adds its file.
"""

from __future__ import annotations

import json
import os
import re

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
PASSES = {"high": 3, "default": 1}


def matmul_least_s(num_qubits: int, dim: int, rung: str) -> float:
    """One D x D complex matrix over the whole state at ``rung``."""
    products = 3 * 2.0 * (1 << num_qubits) * dim
    if rung == "highest":
        t_ops = products / FP32_FLOPS
    else:
        t_ops = PASSES[rung] * products / BF16_FLOPS
    return max(t_ops, bytes_least_s(num_qubits, 1.0))


def bytes_least_s(num_qubits: int, share: float) -> float:
    """``share`` of the state pair read once and written once."""
    return share * 16.0 * (1 << num_qubits) / HBM_BYTES


_NAME = re.compile(r"(?:^|[\s:*&])(\w+)\s*(<[^()]*>)?\s*\(")


def parse_kernel(name: str):
    """(function name, template arguments) of a demangled kernel name, such
    as ``void (anonymous namespace)::mm_high_kernel<512, true>(float
    const*, ...)`` -> ("mm_high_kernel", ["512", "true"])."""
    m = _NAME.search(name.replace("(anonymous namespace)::", ""))
    if not m:
        return name, []
    args = m.group(2)
    return m.group(1), ([a.strip() for a in args[1:-1].split(",")]
                        if args else [])


def _pick(value, args):
    """A table value, or ``{"arg": i, <arg text>: value}``: the value for
    the launch's i-th template argument."""
    if isinstance(value, dict):
        return value[args[value["arg"]]]
    return value


class KernelTable:
    """Kernel name -> least time of one launch at ``num_qubits``.

    Each ``kernels/<kernel>.json`` holds ``{"kernel": <function name>,
    "work": "matmul" | "bytes", ...}``: for "matmul" the matrix side ``D``
    and the ``rung`` ("high", "default", "highest"); for "bytes" the
    ``state_share`` every launch must move at least.  ``D`` and ``rung`` may
    read a template argument: ``{"arg": 0}`` takes it as a number,
    ``{"arg": 1, "true": "high", "false": "default"}`` maps it."""

    def __init__(self, directory: str):
        self.entries = {}
        for fname in sorted(os.listdir(directory)):
            if fname.endswith(".json"):
                with open(os.path.join(directory, fname)) as f:
                    entry = json.load(f)
                self.entries[entry["kernel"]] = entry

    def least_s(self, name: str, num_qubits: int):
        """(least seconds, mapped?) of one launch of ``name``."""
        func, args = parse_kernel(name)
        entry = self.entries.get(func)
        if entry is None:
            return bytes_least_s(num_qubits, 1.0), False
        if entry["work"] == "matmul":
            dim = entry["D"]
            if isinstance(dim, dict):
                dim = int(args[dim["arg"]])
            return matmul_least_s(num_qubits, dim,
                                  _pick(entry["rung"], args)), True
        return bytes_least_s(num_qubits, entry["state_share"]), True
