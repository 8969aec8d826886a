"""Roofline accounting for circuit programs, and the wide (``mxu``)
engine's fusion cost classes.

A JAX-free copy of the JAX package's ``utils/roofline.py``.
``CostModel``, ``wide_program_cost`` and ``reference_gate_cost`` count the
same operations and bytes as there; their denominators are the card's:
the H100 80GB HBM3's datasheet peaks (3.35 TB/s, 67 TFLOP/s fp32, 989
TFLOP/s bf16 dense), and beside them ``COPY_BYTES_PER_S``, the copy rate
kernel 11 measured on such a card (see below).

``kh_block_costs``'s two tuples are the JAX package's calibration:
per-block times by kh class (the number of high qubits in a fused block)
measured on its original accelerator, not on the card.  They stay as they
are because the native fuser (csrc/qsim_fuse.cpp) uses them to choose
which open block absorbs a gate, and both packages must fuse a circuit
into the same ops.  Only their ratios enter the fuser; they are not times
of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# H100 80GB HBM3 (SXM) datasheet peaks.
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
# Kernel 11's grid copy (csrc/copy_probe.cu) on one H100 80GB HBM3 at a
# 700.00 W power limit: the n = 30 (re, im) pair, 2^34 bytes read and
# written, in 5.8191 ms (``chip_ab.py --phases copy``, the card's
# measured rate beside its peak).
COPY_BYTES_PER_S = (1 << 34) / 5.8191e-3


@dataclass
class CostModel:
    flops: float
    hbm_bytes: float

    def seconds(self, peak_flops=H100_F32_FLOPS,
                hbm_bw=H100_HBM_BYTES_PER_S):
        """Roofline lower bound: the larger of compute and memory time."""
        return max(self.flops / peak_flops, self.hbm_bytes / hbm_bw)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def wide_program_cost(ops: Sequence, num_qubits: int,
                      lane_qubits: int = 7) -> CostModel:
    """FLOPs + memory bytes of the wide-matmul program (engine/wide.py).

    Per op: state read+write (2 arrays x 2 passes x 4 B x 2^n) plus the
    D x D matrix pair; 4 real matmuls of (2^n / D, D) @ (D, D).
    """
    n = num_qubits
    state_elems = 1 << n
    flops = 0.0
    bytes_ = 0.0
    for op in ops:
        kh = sum(1 for q in op.qubits if q >= lane_qubits)
        D = (1 << kh) * (1 << lane_qubits)
        flops += 4 * 2 * state_elems * D          # 4 real matmuls
        bytes_ += 4 * 4 * state_elems             # r/w of both arrays, f32
        bytes_ += 2 * 4 * D * D                   # matrix pair
    return CostModel(flops, bytes_)


def reference_gate_cost(num_gates_1q: int, num_cx: int,
                        num_qubits: int) -> CostModel:
    """Unfused gate-by-gate cost (the reference naive variant's accounting:
    28 FLOP / 8 B per 2x2 butterfly pair, its slide 14)."""
    n = num_qubits
    pairs = 1 << (n - 1)
    return CostModel(
        flops=28.0 * pairs * num_gates_1q,
        hbm_bytes=8.0 * 2 * pairs * (num_gates_1q + num_cx),
    )

# Two regimes of the JAX package's calibration: a working set below its
# device memory's bandwidth bound (cost ~ 2^kh, anchored at n = 20) and a
# bandwidth-bound one (flat-ish, anchored at n = 24).
_KH_COSTS_COMPUTE_BOUND = (0.0214, 0.0468, 0.1028)
_KH_COSTS_HBM_BOUND = (0.863, 1.014, 1.767)


def kh_block_costs(num_qubits: int) -> tuple:
    """Per-block cost by kh class for the fusion emitter's cost model.

    Only the ratios matter, so the anchor closest to the requested state
    size is returned un-rescaled, as in the JAX package.
    """
    return (_KH_COSTS_COMPUTE_BOUND if num_qubits <= 21
            else _KH_COSTS_HBM_BOUND)
