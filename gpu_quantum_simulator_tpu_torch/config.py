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
# JAX package (whose TPU A/B runs chose the width; see its config.py).  The
# port runs only "highest", so on the card "auto" is "highest" at every
# width it covers (n <= 22).
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


STRATEGIES = (
    "auto",        # width-based dispatch; in the port always prefetch
                   # (engine.simulator._auto_strategy)
    "reference",   # NumPy complex128 ground truth (quantum_simulator.c semantics)
    "naive",       # one jitted device call per gate (ref: naive launch-per-gate)
    "fused2x2",    # host-side per-qubit 2x2 accumulation (ref: preproces)
    "fused3in1",   # flush+flush+CNOT in one dispatch (ref: preproces_3in1, debugged)
    "fused4x4",    # pair state machine -> 4x4 blocks (ref: 4x4, its fastest)
    "megakernel",  # whole fused op-list unrolled into ONE jit (ref: constant/texture)
    "scan",        # recompile-free lax.scan over dense gate tables
    "mxu",         # k-qubit fusion to 128x128 blocks on the MXU (TPU-native flagship)
    "prefetch",    # recompile-free: one Pallas kernel per (n, cap), runtime op tables
    "pallas",      # mxu pipeline with hand-written Pallas kernels (Karatsuba matmul)
    "vmem",        # whole circuit inside chunked Pallas kernels, state VMEM-resident (n<=19)
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
    # max fused block width for the mxu strategy (7 -> 128x128 matrices).
    max_fused_qubits: int = 7
    # matmul precision rung: "highest" (IEEE fp32, no TF32 — the only rung
    # the port runs), "high"/"default" (the JAX package's cheaper MXU
    # rungs; not ported, they raise) or "auto" (resolve_precision above).
    precision: str = "auto"
    # commutation-window size for the fusion emitter (None = the prefetch
    # default, resolve_prefetch_knobs).  Wider windows pack more gates per
    # fused block by absorbing ops into older blocks past disjoint newer ones.
    fusion_window: Optional[int] = None
    # prefetch commutation-aware op scheduling.  None = automatic (on).
    prefetch_reorder: Optional[bool] = None
    # prefetch in-place (aliased) execution: not ported; True raises.
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
