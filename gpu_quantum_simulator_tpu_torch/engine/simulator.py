"""Simulator facade on torch, for the strategies the port runs so far.

Mirrors ``gpu_quantum_simulator_tpu/engine/simulator.py`` on an explicit
``device`` for ``strategy="mxu"`` (the default, engine/wide.py),
``"pallas"`` (engine/pallas_engine.py), ``"prefetch"`` (engine/
prefetch.py; ``"auto"`` resolves to it), ``"vmem"`` (engine/vmem.py),
``"megakernel"`` (engine/megakernel.py, also every strategy's arm at the
smallest widths) and ``"reference"`` (ref/cpu.py: numpy complex128 on the
host, whatever the device; ``run`` and ``run_detailed`` only, as in the JAX
package).  Every other strategy, and every width or precision rung
outside the port's slice, raises NotImplementedError naming its ROADMAP
item; n > 30, and vmem above n = 19, raise ValueError, as in the JAX
package.  Nothing runs on another device than the one asked for.

``prefetch`` runs in place on four column halves from n = 30 (or with
``prefetch_inplace=True``); ``run_device_halves`` returns those halves and
``sample`` reads them, through sampling.py, without a flat 2^n tensor.
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
from ..kernels.block import RUNGS
from ..ops import apply as A
from ..passes.permute import plan_permutation, unpermute_state
from .vmem import VMEM_MAX_QUBITS
from .wide import LANE_QUBITS


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
        self.device = A.resolve_device(device)

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

    def sample(self, circuit: Circuit, num_samples: int,
               seed: int = 0) -> np.ndarray:
        """Measurement sampling (ref: quantum_simulator.c:256-283): int64
        basis indices.

        Above n = 22 the distribution, its CDFs and the searches run on the
        simulator's device (sampling.py) and only the indices reach the
        host: on the column halves when prefetch runs in place, else on the
        flat pair.  Up to n = 22 it is the host sampler (ref/cpu.py) on the
        final state, the JAX package's samples bit for bit.
        """
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.sample(circuit, num_samples, seed=seed)
        n = circuit.num_qubits
        if n > 22 and self.config.strategy != "reference":
            from .. import sampling

            if self._prefetch_inplace(n):
                parts, _ = self.run_device_halves(circuit)
                return sampling.sample_halves(*parts, n, num_samples, seed)
            re, im, _ = self.run_device(circuit)
            return sampling.sample_state_device(re, im, n, num_samples, seed)
        from ..ref.cpu import sample

        return sample(self.run(circuit), num_samples,
                      np.random.default_rng(seed))

    def _prefetch_inplace(self, n: int) -> bool:
        cfg = self.config
        if cfg.strategy != "prefetch":
            return False
        if cfg.prefetch_inplace is not None:
            return bool(cfg.prefetch_inplace)
        return n >= 30

    def run_device_halves(self, circuit: Circuit, initial_parts=None):
        """Run through the in-place prefetch engine and return the state as
        its four (R2, 128) column halves on the simulator's device:
        ``((re0, re1, im0, im1), num_ops)``, original qubit basis.

        The halves are the engine's own buffers; the measurement helpers of
        sampling.py (``sample_halves``, ``norm_halves``, ...) read them as
        they are.  ``initial_parts`` resumes from a prior state (original
        basis): a flat (re, im) pair of length 2^n or the four (R2, 128)
        column halves, numpy arrays or tensors, on the host or the device
        (engine/prefetch.py ``start_halves``).  They are copied, never
        changed, as in the JAX package.
        """
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.run_device_halves(circuit, initial_parts=initial_parts)
        n = circuit.num_qubits
        if not self._prefetch_inplace(n):
            raise ValueError(
                "run_device_halves requires strategy='prefetch' with the "
                "in-place engine (prefetch_inplace=True or n >= 30)")
        _check_run(self.config, n)
        from .prefetch import run_prefetch

        parts, _, num_ops, _ = run_prefetch(
            circuit, self.config, self.device, initial_parts=initial_parts,
            return_halves=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return parts, num_ops

    def run_device(self, circuit: Circuit, initial=None):
        """Run and return (re, im, num_ops): flat float32 tensors on the
        simulator's device, in the original basis.

        ``initial``: optional complex state vector (original basis) to
        resume from instead of |0...0>.
        """
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.run_device(circuit, initial=initial)
        if self.config.strategy == "reference":
            raise ValueError(
                "strategy='reference' runs on the host (ref/cpu.py) and "
                "returns no device state: use run or run_detailed")
        _check_run(self.config, circuit.num_qubits)  # before any planning
        work, perm, initial = self._relabel(circuit, initial)
        re, im, num_ops, residual = self._execute(work, initial)
        re, im = self._restore(re, im, perm, residual)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return re, im, num_ops

    def _relabel(self, circuit: Circuit, initial=None):
        """(work circuit, perm or None, initial in the work basis): hot
        qubits relabeled low for mxu, pallas and vmem, and for any strategy
        with ``permute=True`` (prefetch routes the state back to the
        ORIGINAL basis inside its own plan, so it relabels here only when
        asked)."""
        n = circuit.num_qubits
        perm = None
        work = circuit
        if self.config.permute or self.config.strategy in ("mxu", "pallas",
                                                           "vmem"):
            perm = plan_permutation(circuit)
            if np.array_equal(perm, np.arange(n)):
                perm = None
            else:
                work = circuit.relabeled(perm)
        if initial is not None:
            initial = np.asarray(initial)
            if initial.shape != (1 << n,):
                raise ValueError("initial state has wrong length")
            if perm is not None:
                # map original-basis amplitudes into the relabeled basis
                initial = unpermute_state(initial, np.argsort(perm))
        return work, perm, initial

    @staticmethod
    def _restore(re, im, perm, residual):
        """Compose the relabeling with any layout the engine left behind,
        and undo both with one device unpermute."""
        total = None
        if perm is not None and residual is not None:
            total = residual[perm]
        elif perm is not None:
            total = perm
        elif residual is not None:
            total = residual
        if total is not None and not np.array_equal(total,
                                                    np.arange(len(total))):
            re, im = A.unpermute_device(re, im, [int(p) for p in total])
        return re, im

    def run_detailed(self, circuit: Circuit, initial=None) -> RunResult:
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.run_detailed(circuit, initial=initial)
        t0 = time.perf_counter()
        if self.config.strategy == "reference":
            from ..ref.cpu import simulate_reference

            state = simulate_reference(circuit, initial=initial)
            return RunResult(
                state, circuit.num_qubits, len(circuit), len(circuit),
                time.perf_counter() - t0, self.config.strategy,
            )
        re, im, num_ops = self.run_device(circuit, initial=initial)
        state = A.join_state(re, im)
        return RunResult(
            state, circuit.num_qubits, len(circuit), num_ops,
            time.perf_counter() - t0, self.config.strategy,
        )

    # ------------------------------------------------------------- dispatch
    def _execute(self, circuit: Circuit, initial=None):
        cfg = self.config
        n = circuit.num_qubits
        if cfg.strategy == "prefetch":
            from .prefetch import run_prefetch

            return run_prefetch(
                circuit, cfg, self.device, initial_parts=None
                if initial is None else (initial.real, initial.imag))
        if cfg.strategy == "pallas":
            from .pallas_engine import run_pallas

            return run_pallas(circuit, cfg, self.device, initial=initial)
        if cfg.strategy == "megakernel" or n <= LANE_QUBITS:
            # the JAX package's small-width arms, each with its own fusion
            from ..passes.fuse4x4 import fuse_4x4
            from ..passes.fuse_k import fuse_k
            from .megakernel import run_megakernel

            if cfg.strategy == "megakernel":
                ops = fuse_4x4(circuit)
            elif cfg.strategy == "vmem":
                ops = fuse_k(fuse_4x4(circuit), max_qubits=n)
            else:
                ops = _fuse_pipeline(circuit, min(cfg.max_fused_qubits, n),
                                     max_high=None)
            return run_megakernel(ops, n, self.device, initial)
        if cfg.strategy == "vmem":
            return self._run_vmem(circuit, initial)
        return self._run_mxu(circuit, initial)

    def _run_vmem(self, circuit: Circuit, initial=None):
        """The vmem engine (8 <= n <= 19): plain fusion to blocks of <= 7
        low plus 2 high qubits, then one kernel-8 launch per chunk."""
        from .prefetch import _circuit_fingerprint
        from .vmem import build_vmem_program_cached

        cfg = self.config
        n = circuit.num_qubits
        key = ("vmem", _circuit_fingerprint(circuit), n,
               cfg.max_fused_qubits, str(self.device))

        def plan():
            ops = _fuse_pipeline(circuit, min(cfg.max_fused_qubits, 7),
                                 max_high=2)
            return ops, build_vmem_program_cached(ops, n, device=self.device)

        ops, prog = _cached_plan(key, plan)
        re, im = self._start(n, initial)
        re, im = prog(re, im)
        return re, im, len(ops), None

    def _start(self, n: int, initial=None):
        if initial is None:
            return A.initial_state_parts(n, device=self.device)
        return A.split_state(initial, device=self.device)

    def _run_mxu(self, circuit: Circuit, initial=None):
        """The wide engine: cost-model fusion, then the WideProgram."""
        from .prefetch import _circuit_fingerprint
        from .wide import build_wide_program

        cfg = self.config
        n = circuit.num_qubits
        precision = cfg.effective_precision(n)
        k = min(cfg.max_fused_qubits, n)
        # the JAX package's defaults: window-8 cost-model fusion
        window = cfg.fusion_window if cfg.fusion_window else 8
        costm = (cfg.fusion_cost_model
                 if cfg.fusion_cost_model is not None else True)
        # plan cache: a repeat run neither re-fuses nor re-hashes the fused
        # matrices; the device takes the place of the JAX backend's name
        key = (_circuit_fingerprint(circuit), n, precision, k, window, costm,
               str(self.device))

        def plan():
            ops = _fuse_pipeline(circuit, k, max_high=2, window=window,
                                 cost_model=costm)
            return ops, build_wide_program(ops, n, precision=precision,
                                           device=self.device)

        ops, prog = _cached_plan(key, plan)
        re, im = self._start(n, initial)
        re, im = prog(re, im)
        return re, im, len(ops), None


def _check_run(cfg: SimulatorConfig, n: int) -> None:
    """Raise for what the port's mxu, pallas, vmem and megakernel engines do
    not run (the prefetch engine fences its own slice, engine/prefetch.py
    ``run_prefetch``)."""
    if n > 30:
        # fail BEFORE allocating, as the JAX package does
        raise ValueError(
            f"n = {n} exceeds the single-chip ceiling (n = 30); the sharded "
            "engines are not yet ported (ROADMAP queue A, item 8, parallel/)")
    if cfg.strategy == "prefetch":
        return
    if cfg.strategy not in ("mxu", "pallas", "vmem", "megakernel"):
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is not yet ported; the port runs "
            "'mxu', 'pallas', 'prefetch', 'vmem', 'megakernel', 'reference' "
            "and 'auto' (ROADMAP queue A)")
    if cfg.dtype != "complex64":
        raise NotImplementedError(
            "dtype complex128: the port runs complex64 (split float32) only "
            "(ROADMAP queue A, item 8)")
    if cfg.strategy == "vmem" and n > VMEM_MAX_QUBITS:
        raise ValueError(
            f"vmem strategy holds the state in VMEM: n <= {VMEM_MAX_QUBITS} "
            f"(got {n}); use mxu")
    # the megakernel arm (n <= 7, and the megakernel strategy), the pallas
    # and vmem engines ignore the rung (always IEEE fp32), as in the JAX
    # package
    if cfg.strategy == "mxu" and n > LANE_QUBITS \
            and cfg.effective_precision(n) not in RUNGS:
        raise NotImplementedError(
            f"precision {cfg.precision!r}: the port runs the 'highest' "
            "(IEEE fp32) and 'high' (3-pass bf16) rungs (ROADMAP queue A, "
            "item 5, the 'default' rung)")


# mxu plan cache: (circuit fingerprint, n, precision, fusion knobs, device)
# -> (fused ops, WideProgram), and the vmem engine's ("vmem", fingerprint,
# n, max_fused_qubits, device) -> (fused ops, VmemProgram), as in the JAX
# package.  Entries hold device tables, so the limit stays small.
_MXU_PLAN_CACHE: dict = {}
_MXU_PLAN_CACHE_LIMIT = 8


def _cached_plan(key, plan):
    """``_MXU_PLAN_CACHE[key]``, made by ``plan()`` on a miss."""
    cached = _MXU_PLAN_CACHE.get(key)
    if cached is None:
        cached = plan()
        if len(_MXU_PLAN_CACHE) >= _MXU_PLAN_CACHE_LIMIT:
            _MXU_PLAN_CACHE.pop(next(iter(_MXU_PLAN_CACHE)))
        _MXU_PLAN_CACHE[key] = cached
    return cached

_NATIVE_FUSE = None  # tri-state: None unknown, False unavailable, module


def _fuse_pipeline(circuit: Circuit, max_qubits: int, max_high,
                   window: int = 1, cost_model: bool = False):
    """fuse_4x4 + fuse_k, via the native C++ pipeline when available.

    The same native fuser (csrc/qsim_fuse.cpp) with the same arguments as
    the JAX package's ``_fuse_pipeline``: both packages fuse a circuit into
    the same ops.  ``window`` > 1 enables the commutation-aware packing in
    the native emitter.

    ``cost_model``: the wide (``mxu``) engine's mode — split low/high caps
    (a block may hold max_qubits low PLUS max_high high qubits; its cost
    depends only on kh) and kh-cost-aware absorb-candidate selection with
    the JAX package's calibration (utils/roofline.py ``kh_block_costs``).
    """
    global _NATIVE_FUSE
    if _NATIVE_FUSE is None:
        from ..passes import native_fuse as nf

        _NATIVE_FUSE = nf if nf.available() else False
    # The native fuser requires max_qubits >= 2 (csrc/qsim_fuse.cpp rejects
    # smaller); clamping is harmless since fused blocks never exceed n qubits.
    max_qubits = max(2, max_qubits)
    cost = cost_model and max_high is not None
    if _NATIVE_FUSE:
        if cost:
            from ..utils.roofline import kh_block_costs

            return _NATIVE_FUSE.fuse_native(
                circuit, max_qubits, max_high, window=window,
                max_low=max_qubits,
                kh_costs=kh_block_costs(circuit.num_qubits))
        return _NATIVE_FUSE.fuse_native(circuit, max_qubits, max_high,
                                        window=window)
    from ..passes.fuse4x4 import fuse_4x4
    from ..passes.fuse_k import fuse_k

    return fuse_k(fuse_4x4(circuit), max_qubits=max_qubits, max_high=max_high,
                  max_low=max_qubits if cost else None)


def simulate(circuit: Circuit, strategy: str = "mxu", device="cuda",
             **kwargs) -> np.ndarray:
    """One-shot convenience: final state in the original basis."""
    return Simulator(SimulatorConfig(strategy=strategy, **kwargs),
                     device=device).run(circuit)
