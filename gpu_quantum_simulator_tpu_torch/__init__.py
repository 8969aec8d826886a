"""gpu_quantum_simulator_tpu_torch — the simulator on PyTorch and CUDA.

The port of ``gpu_quantum_simulator_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100.  It imports ``torch`` and
never ``jax``, and never the JAX package: the host modules it needs
(``ir``, ``passes``, ``models``, ``ref``, ``config`` and the numpy planner)
are JAX-free copies, held to the originals by the tests.

It runs every strategy of the JAX package: ``mxu`` (the default
config), ``pallas``, ``prefetch``, ``vmem`` (n <= 19) and ``megakernel``,
e.g. ``Simulator(device="cuda")``, up to 30 qubits at the "highest"
(IEEE fp32) and "high" (3-pass bf16) precision rungs, through the kernels in
``kernels/`` (CUDA sources in ``csrc/``), with every strategy's smallest
widths on the megakernel arm, and the reference's per-gate ablation rows
(``naive``, ``fused2x2``, ``fused3in1``, ``fused4x4``, ``scan``) as torch
ops.  The QASM front-end (``qasm/``), checkpoints (``utils/checkpoint.py``)
and the CLI (``python -m gpu_quantum_simulator_tpu_torch circuit.qasm``)
are the JAX package's.  The facade's program entry points
(``run_device_parts``, ``run_device_iterated`` — a CUDA graph replayed per
repetition on a card — and ``run_many``), the observables, the sampling
helpers, the circuit families and unitary synthesis (``ir/decompose.py``)
are the JAX package's.  So are the workloads on the state: gradients and
VQE (``gradients.py``, ``optimizer=`` a torch optimizer factory in place
of an optax transform), dynamic circuits and noisy trajectories
(``dynamic.py``, ensemble uniforms from a seeded ``torch.Generator`` in
place of ``jax.random``), density matrices (``density.py``), mitigation,
classical shadows, the MPS and stabilizer simulators and the Qiskit
import.  Every entry point runs on the card unless it is passed
``device="cpu"``, where the same paths run each kernel's plain torch
version.  Every precision rung ("highest", "high", "default") and
complex128 (on mxu, the megakernel, the per-gate engines, the dense
sharded engine and reference) run.

``strategy="sharded"`` (``parallel/``) cuts the state into 2^d shards, one
pair a device of a mesh, in one process: ``Simulator(SimulatorConfig(
strategy="sharded", mesh_shape=(8,)), device=["cuda:0"] * 8)`` runs eight
shards on one card (``device=["cpu"] * 8`` in the tests), and
``device="cuda"`` with no ``mesh_shape`` shards over every visible card.
Every shard runs the prefetch chain's kernels; a gate on a shard-index
qubit is a half-block exchange between two shards.  It is the one
strategy above 30 qubits (n = 31 on one H100 over eight shards), and its
state stays sharded: ``run_device`` returns shard lists, sampling.py reads
them, ``utils/checkpoint.py`` saves them shard by shard.

Qubit convention matches the JAX package: qubit ``k`` is bit ``k`` of the
basis index (little-endian).
"""

from .ir.circuit import Gate, Circuit
from .qasm.parser import (QasmError, parse_qasm, parse_qasm_dynamic,
                          parse_qasm_dynamic_file, parse_qasm_file)
from .ir.oplist import circuit_unitary
from .ir import gates
from .engine.simulator import RunResult, Simulator, simulate
from .config import SimulatorConfig
from . import models
from .dynamic import DynamicCircuit, run_dynamic, run_dynamic_batched
from .density import DensitySimulator, NoisyCircuit
from .gradients import (adjoint_gradient, make_adjoint_value_and_grad,
                        parameter_shift, run_vqe)
from .observables import (expectation_pauli, expectation_pauli_sum,
                          overlap, pauli_decompose, state_fidelity)
from .interop import from_qiskit
from .mps import MPS, run_mps
from .mitigation import (folded, mitigate_readout,
                         mitigate_readout_expectation_z,
                         zne_expectation)
from .shadows import shadow_snapshots, shadows_expectation
from .sampling import (
    expectation_z,
    norm_device,
    sample_state_device,
    top_amplitudes_device,
)

__all__ = [
    "Gate",
    "Circuit",
    "gates",
    "models",
    "circuit_unitary",
    "QasmError",
    "parse_qasm",
    "parse_qasm_dynamic",
    "parse_qasm_dynamic_file",
    "parse_qasm_file",
    "RunResult",
    "Simulator",
    "simulate",
    "SimulatorConfig",
    "sample_state_device",
    "top_amplitudes_device",
    "expectation_z",
    "norm_device",
    "DynamicCircuit",
    "run_dynamic",
    "run_dynamic_batched",
    "DensitySimulator",
    "NoisyCircuit",
    "adjoint_gradient",
    "make_adjoint_value_and_grad",
    "parameter_shift",
    "run_vqe",
    "expectation_pauli",
    "expectation_pauli_sum",
    "pauli_decompose",
    "overlap",
    "state_fidelity",
    "from_qiskit",
    "folded",
    "zne_expectation",
    "mitigate_readout",
    "MPS",
    "run_mps",
    "mitigate_readout_expectation_z",
    "shadow_snapshots",
    "shadows_expectation",
]
