"""Simulator facade on torch, for the strategies the port runs so far.

Mirrors ``gpu_quantum_simulator_tpu/engine/simulator.py`` for
``strategy="prefetch"`` (and ``"auto"``, which resolves to it), on an
explicit ``device``.  Every other strategy, and every width or precision
rung outside the prefetch slice, raises NotImplementedError naming its
ROADMAP item; nothing runs on another device than the one asked for.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import SimulatorConfig
from ..ir.circuit import Circuit
from ..ops import apply as A


@dataclass
class RunResult:
    state: np.ndarray          # final complex amplitudes, ORIGINAL qubit basis
    num_qubits: int
    num_gates: int
    num_fused_ops: int
    seconds: float             # wall-clock: passes + execution + D2H
    strategy: str


def _auto_strategy(cfg: SimulatorConfig, n: int) -> str:
    """Width-based engine dispatch for ``strategy='auto'``.

    The JAX package's 23..28 ``mxu`` band encodes a TPU link's transfer
    cost and is not copied: the port's ``auto`` is ``prefetch`` (which
    raises outside its slice) until card measurements say otherwise.
    """
    if cfg.mesh_shape is not None:
        raise NotImplementedError(
            "a device mesh means the sharded engine, not yet ported "
            "(ROADMAP queue A, parallel/ on torch.distributed)")
    return "prefetch"


class Simulator:
    def __init__(self, config: Optional[SimulatorConfig] = None,
                 device="cuda"):
        self.config = config or SimulatorConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "false; pass device='cpu' for the plain torch path")

    def _resolved(self, n: int) -> "Simulator":
        """Resolve ``strategy='auto'`` to a concrete engine for width n."""
        if self.config.strategy != "auto":
            return self
        return Simulator(dataclasses.replace(
            self.config, strategy=_auto_strategy(self.config, n)),
            device=self.device)

    # ------------------------------------------------------------------ API
    def run(self, circuit: Circuit, initial=None) -> np.ndarray:
        return self.run_detailed(circuit, initial=initial).state

    def run_device(self, circuit: Circuit, initial=None):
        """Run and return (re, im, num_ops): flat float32 tensors on the
        simulator's device, in the original basis.

        ``initial``: optional complex state vector (original basis) to
        resume from instead of |0...0>.
        """
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.run_device(circuit, initial=initial)
        if self.config.permute:
            raise NotImplementedError(
                "permute=True needs the device unpermute (ops/apply.py "
                "unpermute_device), not yet ported (ROADMAP queue A); the "
                "prefetch plan already returns the original basis")
        if initial is not None and np.shape(initial) != (1 << circuit.num_qubits,):
            raise ValueError("initial state has wrong length")
        re, im, num_ops, _ = self._execute(circuit, initial)
        return re, im, num_ops

    def run_detailed(self, circuit: Circuit, initial=None) -> RunResult:
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.run_detailed(circuit, initial=initial)
        t0 = time.perf_counter()
        re, im, num_ops = self.run_device(circuit, initial=initial)
        state = A.join_state(re, im)
        return RunResult(
            state, circuit.num_qubits, len(circuit), num_ops,
            time.perf_counter() - t0, self.config.strategy,
        )

    # ------------------------------------------------------------- dispatch
    def _execute(self, circuit: Circuit, initial=None):
        cfg = self.config
        if cfg.strategy != "prefetch":
            raise NotImplementedError(
                f"strategy {cfg.strategy!r} is not yet ported; the port runs "
                "'prefetch' (and 'auto') only (ROADMAP queue A)")
        from .prefetch import run_prefetch

        re, im, num_ops, residual = run_prefetch(
            circuit, cfg, self.device, initial=initial)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return re, im, num_ops, residual


_NATIVE_FUSE = None  # tri-state: None unknown, False unavailable, module


def _fuse_pipeline(circuit: Circuit, max_qubits: int, max_high,
                   window: int = 1):
    """fuse_4x4 + fuse_k, via the native C++ pipeline when available.

    The same native fuser (csrc/qsim_fuse.cpp) with the same arguments as
    the JAX package's ``_fuse_pipeline`` (whose ``cost_model`` arm serves the
    ``mxu`` engine only and is not ported): both packages fuse a circuit
    into the same ops.  ``window`` > 1 enables the commutation-aware
    packing in the native emitter.
    """
    global _NATIVE_FUSE
    if _NATIVE_FUSE is None:
        from ..passes import native_fuse as nf

        _NATIVE_FUSE = nf if nf.available() else False
    # The native fuser requires max_qubits >= 2 (csrc/qsim_fuse.cpp rejects
    # smaller); clamping is harmless since fused blocks never exceed n qubits.
    max_qubits = max(2, max_qubits)
    if _NATIVE_FUSE:
        return _NATIVE_FUSE.fuse_native(circuit, max_qubits, max_high,
                                        window=window)
    from ..passes.fuse4x4 import fuse_4x4
    from ..passes.fuse_k import fuse_k

    return fuse_k(fuse_4x4(circuit), max_qubits=max_qubits, max_high=max_high)


def simulate(circuit: Circuit, strategy: str = "auto", device="cuda",
             **kwargs) -> np.ndarray:
    """One-shot convenience: final state in the original basis."""
    return Simulator(SimulatorConfig(strategy=strategy, **kwargs),
                     device=device).run(circuit)
