"""gpu_quantum_simulator_tpu_torch — the simulator on PyTorch and CUDA.

The port of ``gpu_quantum_simulator_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100.  It imports ``torch`` and
never ``jax``, and never the JAX package: the host modules it needs
(``ir``, ``passes``, ``models``, ``ref``, ``config`` and the numpy planner)
are JAX-free copies, held to the originals by the tests.

So far it runs the prefetch engine's main path:
``Simulator(SimulatorConfig(strategy="prefetch"), device="cuda")`` at
9 <= n <= 22 qubits and the "highest" (IEEE fp32) precision rung, through
the block and relayout kernels in ``kernels/`` (CUDA sources in ``csrc/``).
On ``device="cpu"`` the same path runs each kernel's plain torch version.
Anything else raises NotImplementedError naming its ROADMAP item.

Qubit convention matches the JAX package: qubit ``k`` is bit ``k`` of the
basis index (little-endian).
"""

from .ir.circuit import Gate, Circuit
from .ir import gates
from .engine.simulator import RunResult, Simulator, simulate
from .config import SimulatorConfig
from . import models

__all__ = [
    "Gate",
    "Circuit",
    "gates",
    "models",
    "RunResult",
    "Simulator",
    "simulate",
    "SimulatorConfig",
]
