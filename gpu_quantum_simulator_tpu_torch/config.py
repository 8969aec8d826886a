"""Simulator configuration.

The reference selects its optimization strategy by compiling a different
binary (nine programs, SURVEY §2.1) and tunes via compile-time #defines
(NUMTHREAD/NUMBLOCKS/MAX_COSTANT, quantum_simulator_preproces_constant.cu:27-32).
Here every ablation is a config on one library.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# "auto" precision resolves to the "high" rung from this width up, as in the
# JAX package (whose TPU A/B runs chose the width; see its config.py; the
# choice is not measured on the card).
PRECISION_AUTO_HIGH_MIN_QUBITS = 24


def resolve_precision(precision: str, num_qubits: int) -> str:
    """Materialize the "auto" precision rung for a circuit width.

    Every engine resolves through here before building (and before keying
    any plan/kernel cache), so auto and the equivalent explicit setting
    share compiled programs.
    """
    if precision != "auto":
        return precision
    return ("high" if num_qubits >= PRECISION_AUTO_HIGH_MIN_QUBITS
            else "highest")


# Every strategy of the JAX package.  The port runs "mxu", "pallas",
# "prefetch", "vmem", "megakernel", "reference" and "auto"; the others
# raise NotImplementedError (ROADMAP A).
STRATEGIES = (
    "auto",        # width-based dispatch; in the port always prefetch
                   # (engine.simulator._auto_strategy)
    "reference",   # NumPy complex128 ground truth (quantum_simulator.c semantics)
    "naive",       # one jitted device call per gate (ref: naive launch-per-gate)
    "fused2x2",    # host-side per-qubit 2x2 accumulation (ref: preproces)
    "fused3in1",   # flush+flush+CNOT in one dispatch (ref: preproces_3in1, debugged)
    "fused4x4",    # pair state machine -> 4x4 blocks (ref: 4x4, its fastest)
    "megakernel",  # the whole fused op list as torch ops, one callable
                   # (engine/megakernel.py; ref: constant/texture)
    "scan",        # recompile-free lax.scan over dense gate tables
    "mxu",         # the default: cost-model fusion to blocks of <= 7 low + 2
                   # high qubits, each one D <= 512 matrix product on the
                   # (R, 128) state; kh=0 runs chained in one CUDA kernel
                   # (engine/wide.py)
    "prefetch",    # one block kernel per step over runtime op tables
    "pallas",      # <= 7-qubit blocks planned onto the lane qubits, each one
                   # 128x128 product in the CUDA chain kernel, plus qubit
                   # swap copies (engine/pallas_engine.py)
    "vmem",        # 96-op chunks, each one cooperative CUDA launch with the
                   # state in L2 (engine/vmem.py, n <= 19)
    "sharded",     # mesh-sharded state vector, all_to_all qubit swaps
)


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    strategy: str = "mxu"
    # complex64 (split float32, like the GPU variants) or complex128 (like the
    # CPU reference; the JAX package's parity-checking arm, not ported).
    dtype: str = "complex64"
    # qubit-relabeling pass (correct version of ref's permute variants);
    # output is always returned in the ORIGINAL basis (ref defect #7 avoided).
    permute: bool = False
    # max fused block width (mxu: low qubits per block, plus up to 2 high;
    # pallas and prefetch: qubits per block, at most 7).
    max_fused_qubits: int = 7
    # matmul precision rung: "highest" (IEEE fp32, no TF32), "high" (the
    # 3-pass bf16 product on the tensor cores), "default" (not ported; it
    # raises) or "auto" (resolve_precision above).
    precision: str = "auto"
    # commutation-window size for the fusion emitter (None = the prefetch
    # default, resolve_prefetch_knobs).  Wider windows pack more gates per
    # fused block by absorbing ops into older blocks past disjoint newer ones.
    fusion_window: Optional[int] = None
    # kh-cost-aware fusion of the mxu engine (None = on, as in the JAX
    # package).  Splits the low/high width caps and picks absorb candidates
    # by predicted wide-engine block cost (utils.roofline.kh_block_costs).
    fusion_cost_model: Optional[bool] = None
    # prefetch commutation-aware op scheduling.  None = automatic (on).
    prefetch_reorder: Optional[bool] = None
    # prefetch in-place execution on four column halves, with no second
    # state buffer.  None = automatic: in place at n = 30, as in the JAX
    # package.
    prefetch_inplace: Optional[bool] = None
    # prefetch fusion high-qubit cap (None = 2) and per-block mat-table
    # capacity (None = 8 at n >= 21, else the engine's CAP_MATS).
    prefetch_max_high: Optional[int] = None
    prefetch_cap_mats: Optional[int] = None
    # device mesh for the sharded engine: not ported; setting it raises.
    mesh_shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; pick one of {STRATEGIES}"
            )
        if self.dtype not in ("complex64", "complex128"):
            raise ValueError("dtype must be complex64 or complex128")
        if not (1 <= self.max_fused_qubits <= 10):
            raise ValueError("max_fused_qubits must be in [1, 10]")
        if self.precision not in ("auto", "highest", "high", "default"):
            raise ValueError("precision must be auto/highest/high/default")

    def effective_precision(self, num_qubits: int) -> str:
        """The concrete precision rung for a circuit of this width."""
        return resolve_precision(self.precision, num_qubits)
