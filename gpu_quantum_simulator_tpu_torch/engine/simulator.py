"""Simulator facade on torch.

Mirrors ``gpu_quantum_simulator_tpu/engine/simulator.py`` on an explicit
``device`` for ``strategy="mxu"`` (the default, engine/wide.py),
``"pallas"`` (engine/pallas_engine.py), ``"prefetch"`` (engine/
prefetch.py; ``"auto"`` resolves to it), ``"vmem"`` (engine/vmem.py),
``"megakernel"`` (engine/megakernel.py, also every strategy's arm at the
smallest widths), the reference's ablation rows ``"naive"``,
``"fused2x2"``, ``"fused3in1"``, ``"fused4x4"`` (engine/naive.py) and
``"scan"`` (engine/scan.py), ``"reference"`` (ref/cpu.py: numpy
complex128 on the host, whatever the device; ``run`` and ``run_detailed``
only, as in the JAX package) and ``"sharded"``: the state cut into 2^d
shards over a mesh of devices (parallel/mesh.py), run by the segmented
prefetch chain on every shard (parallel/sharded_prefetch.py) or, for
complex128, shards below 9 qubits and ``shard_segmented=False``, by the
dense engine (parallel/sharded.py).  ``device`` may then be a list of
devices, which may repeat one (``["cuda:0"] * 8``: a mesh on one card);
one device string means every visible device of its type.  The other
strategies run on the first device of a list.  n > 30 raises ValueError
unless the strategy is "sharded", and vmem above n = 19, as in the JAX
package.  Nothing runs on another device than the ones asked for.

Rungs: "highest" (IEEE fp32), "high" (3-pass bf16 on the tensor cores)
and "default" (one bf16 pass, the hi.hi term of "high", on the same
kernels' second instantiations); "auto" is "high" from n = 24, else
"highest", never "default".  The megakernel, pallas, vmem and per-gate
engines ignore the rung, as in the JAX package.

``dtype="complex128"`` runs float64 from the tables to the result on mxu
(every block a float64 ``torch.matmul`` step, no chain kernel), the
megakernel, the per-gate engines and ``reference``: the JAX package's
parity arms, torch ops with no hand kernel.  prefetch, pallas and vmem
raise ValueError for it: their kernels are float32-only (the JAX
package's Mosaic kernels run no float64 on the chip).

``prefetch`` runs in place on four column halves from n = 30 (or with
``prefetch_inplace=True``); ``run_device_halves`` returns those halves and
``sample`` reads them, through sampling.py, without a flat 2^n tensor.

A sharded run's device state is a pair of shard lists, ``re[s]``/``im[s]``
the (2^(n-d),) tensors of shard s on its device, in the original basis:
``run_device`` and the entry points return it so, never put together on
one device; sampling.py reads it shard by shard, and ``run``/
``run_detailed`` copy each shard into its slice of one host buffer.

The program entry points are the JAX package's: ``run_device_parts`` runs
a layout-closed program (``_build_program``) on a device-resident pair,
``run_device_iterated`` repeats one body (a CUDA graph replayed per
repetition on a card, engine/graphs.py), and ``run_many`` queues a batch
of circuits before it fetches any result.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..config import SimulatorConfig
from ..ir.circuit import Circuit
from ..ops import apply as A
from ..parallel.sharded import is_sharded
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
    raises outside its slice) until card measurements say otherwise.  An
    explicit device mesh always means the sharded engine, as in the JAX
    package.
    """
    if cfg.mesh_shape is not None:
        return "sharded"
    return "prefetch"


def _entry(fn):
    """A facade entry point: a request of its own in ``telemetry``."""
    name = "qsim/" + fn.__name__

    @functools.wraps(fn)
    def entry(self, *args, **kwargs):
        with telemetry.request(name):
            return fn(self, *args, **kwargs)

    return entry


class Simulator:
    def __init__(self, config: Optional[SimulatorConfig] = None,
                 device="cuda"):
        self.config = config or SimulatorConfig()
        if isinstance(device, (list, tuple)):
            if not device:
                raise ValueError("device: an empty list of devices")
            self.devices = [A.resolve_device(d) for d in device]
            self.device = self.devices[0]
        else:
            self.devices = None
            self.device = A.resolve_device(device)

    def _resolved(self, n: int) -> "Simulator":
        """Resolve ``strategy='auto'`` to a concrete engine for width n."""
        if self.config.strategy != "auto":
            return self
        return Simulator(dataclasses.replace(
            self.config, strategy=_auto_strategy(self.config, n)),
            device=self.devices or self.device)

    def mesh(self):
        """The sharded engine's mesh: ``config.mesh_shape`` over the devices
        given (a list), or over every visible device of ``device``'s type;
        cut down to a power of two when no shape is set.  A shape larger
        than its devices raises ValueError."""
        from ..parallel.mesh import make_mesh, visible_devices

        cfg = self.config
        devices = (self.devices if self.devices is not None
                   else visible_devices(self.device))
        return make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, devices)

    def _shard_segmented(self, n: int) -> bool:
        """Route 'sharded' through the segmented prefetch chain?"""
        cfg = self.config
        if cfg.strategy != "sharded":
            return False
        if cfg.dtype != "complex64":
            return False
        from ..parallel.mesh import num_global_qubits
        from .prefetch import MIN_QUBITS

        d = num_global_qubits(self.mesh(), cfg.mesh_axis_names[0])
        if n - d < MIN_QUBITS:
            return False
        if cfg.shard_segmented is not None:
            return bool(cfg.shard_segmented)
        return True

    # ------------------------------------------------------------------ API
    @_entry
    def run(self, circuit: Circuit, initial=None) -> np.ndarray:
        return self.run_detailed(circuit, initial=initial).state

    @_entry
    def sample(self, circuit: Circuit, num_samples: int,
               seed: int = 0) -> np.ndarray:
        """Measurement sampling (ref: quantum_simulator.c:256-283): int64
        basis indices.

        Above n = 22 the distribution, its CDFs and the searches run on the
        simulator's device (sampling.py) and only the indices reach the
        host: on the column halves when prefetch runs in place, shard by
        shard for "sharded", else on the flat pair.  Up to n = 22 it is
        the host sampler (ref/cpu.py) on the final state, the JAX package's
        samples bit for bit.
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

        if self.config.strategy == "reference":
            state = self.run(circuit)
        else:
            # every device run of ``sample`` goes through run_device or
            # run_device_halves (callers hook them to keep the state)
            re, im, _ = self.run_device(circuit)
            state = _join(re, im)
        return sample(state, num_samples, np.random.default_rng(seed))

    def _prefetch_inplace(self, n: int) -> bool:
        cfg = self.config
        if cfg.strategy != "prefetch":
            return False
        if cfg.prefetch_inplace is not None:
            return bool(cfg.prefetch_inplace)
        return n >= 30

    @_entry
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

    @_entry
    def run_device(self, circuit: Circuit, initial=None):
        """Run and return (re, im, num_ops): flat float32 tensors on the
        simulator's device (for "sharded": shard lists on the mesh's
        devices), in the original basis, once the device has run them.

        ``initial``: optional complex state vector (original basis) to
        resume from instead of |0...0>.
        """
        sim = self._resolved(circuit.num_qubits)
        re, im, num_ops = sim._run_device(circuit, initial)
        _synchronize(re, sim.device)
        return re, im, num_ops

    def _run_device(self, circuit: Circuit, initial=None):
        """``run_device`` without the wait: the run is queued on the
        device's stream and the tensors are returned at once (``run_many``
        dispatches through it)."""
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim._run_device(circuit, initial)
        if self.config.strategy == "reference":
            raise ValueError(
                "strategy='reference' runs on the host (ref/cpu.py) and "
                "returns no device state: use run or run_detailed")
        _check_run(self.config, circuit.num_qubits)  # before any planning
        with telemetry.span("qsim/plan"):
            work, perm, initial = self._relabel(circuit, initial)
        re, im, num_ops, residual = self._execute(work, initial)
        re, im = self._restore(re, im, perm, residual)
        return re, im, num_ops

    @_entry
    def run_device_parts(self, circuit: Circuit, parts):
        """Run ``circuit`` on a device-resident flat (re, im) pair and return
        ``(re, im, num_ops)`` on the simulator's device.

        The layout-closed program path: no qubit relabeling, input and
        output both in the original basis, nothing of size 2^n crosses to
        the host (the building block of dynamic-circuit trajectories).
        ``parts`` (tensors or numpy arrays, original basis) are copied once
        on the device and never changed: the programs write into the pair
        they are handed.  For "sharded" ``parts`` may also be shard lists,
        and the result is a pair of shard lists.  Programs come from the
        same caches as the plain runs, so a repeat re-plans nothing.
        """
        sim = self._resolved(circuit.num_qubits)
        if sim is not self:
            return sim.run_device_parts(circuit, parts)
        from .prefetch import _component

        if len(parts) != 2:
            raise ValueError(f"parts: a flat (re, im) pair, got {len(parts)} "
                             "arrays")
        cfg = self.config
        n = circuit.num_qubits
        with telemetry.span("qsim/plan"):
            fn, nops = self._build_program(circuit)
        if cfg.strategy == "sharded":
            from ..parallel.sharded import shard_component

            re, im = (shard_component(p, fn.devices, _real_dtype(cfg))
                      for p in parts)
        else:
            re, im = (_component(p, (1 << n,), self.device, _real_dtype(cfg))
                      for p in parts)
        re, im = fn(re, im)
        return re, im, nops

    @_entry
    def run_device_iterated(self, body: Circuit, repetitions: int,
                            prefix: Optional[Circuit] = None,
                            suffix: Optional[Circuit] = None):
        """Run ``prefix; body^repetitions; suffix`` building each part's
        program ONCE; returns ``(re, im, num_ops)`` on the simulator's
        device, in the original basis.

        Structured deep circuits (Grover iterations, Trotter steps, QAOA
        layers) repeat one block many times.  All parts share one qubit
        relabeling, so no basis shuffling happens between repetitions.
        Strategies: mxu, vmem, megakernel, prefetch (its flat program,
        planned layout-closed: ``final_layout`` = identity) and sharded
        (every part planned layout-closed; shard lists in and out).  On a
        card the mxu and prefetch bodies are captured once as a CUDA graph
        and replayed ``repetitions`` times (engine/graphs.py; the JAX
        package's ``lax.scan`` arms); vmem, the megakernel arm and sharded
        loop over the program, as in the JAX package.  On the CPU every
        strategy loops.
        """
        sim = self._resolved(body.num_qubits)
        if sim is not self:
            return sim.run_device_iterated(
                body, repetitions, prefix=prefix, suffix=suffix)
        from .graphs import iterate
        from .prefetch import PrefetchProgram
        from .wide import WideProgram

        with telemetry.span("qsim/plan"):
            perm, programs = self._iterated_programs(body, repetitions,
                                                     prefix, suffix)
        n = body.num_qubits
        if self.config.strategy == "sharded":
            from ..parallel.sharded import initial_shards

            re, im = initial_shards(n, self.mesh().device_list,
                                    _real_dtype(self.config))
        else:
            re, im = A.initial_state_parts(n, dtype=_real_dtype(self.config),
                                           device=self.device)
        total_ops = 0
        for fn, nops, reps in programs:
            total_ops += nops * reps
            if reps > 1 and isinstance(fn, (WideProgram, PrefetchProgram)):
                re, im = iterate(fn, re, im, reps)
            else:
                for _ in range(reps):
                    re, im = fn(re, im)
        if perm is not None:
            re, im = self._restore(re, im, perm, None)
        return re, im, total_ops

    def _iterated_programs(self, body: Circuit, repetitions: int,
                           prefix: Optional[Circuit] = None,
                           suffix: Optional[Circuit] = None):
        """(perm or None, [(program, num_ops, repetitions)]) for
        ``run_device_iterated``: every part relabeled by one permutation
        planned over all of them (usage summed), in the order prefix, body,
        suffix, parts that do not run left out."""
        cfg = self.config
        if cfg.strategy not in ("mxu", "vmem", "megakernel", "sharded",
                                "prefetch"):
            raise ValueError(
                f"run_device_iterated supports mxu/vmem/megakernel/sharded/"
                f"prefetch, not {cfg.strategy!r}")
        n = body.num_qubits
        for part in (prefix, suffix):
            if part is not None and part.num_qubits != n:
                raise ValueError("all parts must have the same qubit count")
        perm = None
        if cfg.permute or cfg.strategy in ("mxu", "vmem", "sharded",
                                           "prefetch"):
            merged = Circuit(n)
            for part in (prefix, body, suffix):
                if part is not None:
                    merged.gates.extend(part.gates)
            perm = plan_permutation(merged)
            if np.array_equal(perm, np.arange(n)):
                perm = None
        programs = []
        for part, reps in ((prefix, 1), (body, repetitions), (suffix, 1)):
            if part is None or reps == 0:
                continue
            if perm is not None:
                part = part.relabeled(perm)
            programs.append((*self._build_program(part), reps))
        return perm, programs

    def _build_program(self, circuit: Circuit):
        """(program, num_ops): a layout-closed (re, im) -> (re, im) program
        on the simulator's device for the program strategies, original
        basis in and out (the JAX package's ``_build_program``).  mxu and
        vmem share the plain runs' plan cache; prefetch is flat, never in
        place, its plan routed back to the identity layout
        (``final_layout``), from ``build_prefetch_program``'s cache.
        sharded plans layout-closed too: the segmented program with
        ``final_layout`` = identity, or the dense one with
        ``restore_layout``, as in the JAX package."""
        cfg = self.config
        n = circuit.num_qubits
        _check_run(cfg, n)
        if cfg.strategy == "sharded":
            return self._sharded_program(circuit)
        if cfg.strategy == "megakernel" or n <= LANE_QUBITS:
            from ..passes.fuse4x4 import fuse_4x4
            from .megakernel import build_megakernel

            ops = fuse_4x4(circuit) if cfg.strategy == "megakernel" else (
                _fuse_pipeline(circuit, min(cfg.max_fused_qubits, n),
                               max_high=None))
            return build_megakernel(ops, n, self.device,
                                    _real_dtype(cfg)), len(ops)
        if cfg.strategy == "vmem":
            ops, prog = self._vmem_program(circuit)
            return prog, len(ops)
        if cfg.strategy == "prefetch":
            from .prefetch import (LANE_QUBITS as PF_LANES, MIN_QUBITS,
                                   _circuit_fingerprint,
                                   build_prefetch_program,
                                   resolve_prefetch_knobs)

            if n < MIN_QUBITS:
                from ..passes.fuse4x4 import fuse_4x4
                from ..passes.fuse_k import fuse_k
                from .megakernel import build_megakernel

                ops = fuse_k(fuse_4x4(circuit),
                             max_qubits=min(cfg.max_fused_qubits, n))
                return build_megakernel(ops, n, self.device), len(ops)
            max_high, cap_mats, window = resolve_prefetch_knobs(cfg, n, False)
            reorder = (cfg.prefetch_reorder
                       if cfg.prefetch_reorder is not None else True)
            precision = cfg.effective_precision(n)
            key = ("prefetch", _circuit_fingerprint(circuit), n, precision,
                   cfg.max_fused_qubits, max_high, cap_mats, window,
                   bool(reorder), str(self.device))

            def plan():
                ops = _fuse_pipeline(
                    circuit, min(cfg.max_fused_qubits, PF_LANES),
                    max_high=max_high, window=window)
                # layout-closed: the plan routes the state back to the
                # identity layout, so repetitions compose in the original
                # basis
                return None, build_prefetch_program(
                    ops, n, precision=precision, cap_mats=cap_mats,
                    final_layout=np.arange(n), reorder=bool(reorder),
                    device=self.device)

            _, prog = _cached_plan(key, plan)
            return prog, prog.num_ops
        ops, prog = self._mxu_program(circuit)
        return prog, len(ops)

    def _sharded_program(self, circuit: Circuit):
        """(layout-closed sharded program, num_ops), from the plan cache."""
        from .prefetch import _circuit_fingerprint

        cfg = self.config
        n = circuit.num_qubits
        mesh = self.mesh()
        segmented = self._shard_segmented(n)
        precision = cfg.effective_precision(n)
        key = ("sharded", _circuit_fingerprint(circuit), n, cfg.dtype,
               precision, cfg.max_fused_qubits, segmented, mesh.key)

        def plan():
            if segmented:
                from ..parallel.sharded_prefetch import ShardedPrefetchProgram
                from .prefetch import LANE_QUBITS as PF_LANES

                ops = _fuse_pipeline(
                    circuit, min(cfg.max_fused_qubits, PF_LANES),
                    max_high=2, window=8)
                prog = ShardedPrefetchProgram(
                    ops, n, mesh, cfg.mesh_axis_names[0],
                    precision=precision, final_layout=np.arange(n))
                return prog.num_ops, prog
            from ..parallel.sharded import ShardedProgram

            prog = ShardedProgram(circuit, cfg, mesh, restore_layout=True)
            return len(prog.plan.items), prog

        nops, prog = _cached_plan(key, plan)
        return prog, nops

    @_entry
    def run_many(self, circuits, terms=None, throttle: int = 8):
        """Pipelined batch execution: every circuit is dispatched before any
        result is fetched, so host planning and enqueueing overlap the
        device's work.

        ``terms=None``: a list of host state vectors.
        ``terms=[(coeff, pauli), ...]``: an np.ndarray of <H> per circuit;
        only the scalars reach the host (the same observable screened over
        many candidate circuits).
        ``throttle``: wait for the device every k dispatches, so that the
        queue does not hold every circuit's tables and states at once.
        """
        circuits = list(circuits)
        if not circuits:
            return [] if terms is None else np.zeros(0)
        evaluate = None
        if terms is not None:
            widths = {c.num_qubits for c in circuits}
            if len(widths) != 1:
                raise ValueError(
                    f"terms mode needs equal widths, got {sorted(widths)}")
            n = widths.pop()
            from ..observables import _parse_terms, _pauli_sum_parts

            parsed, const = _parse_terms(terms, n)

            def evaluate(re, im):
                return _pauli_sum_parts(re, im, parsed, n)

        pending = []
        for i, c in enumerate(circuits):
            re, im, _ = self._run_device(c)
            pending.append(evaluate(re, im) if evaluate is not None
                           else (re, im))
            del re, im
            if throttle and (i + 1) % throttle == 0 \
                    and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        if evaluate is not None:
            return torch.stack([p.to(self.device) for p in pending]
                               ).double().cpu().numpy() + const
        return [_join(re, im) for re, im in pending]

    def _relabel(self, circuit: Circuit, initial=None):
        """(work circuit, perm or None, initial in the work basis): hot
        qubits relabeled low for mxu, pallas, vmem and the dense sharded
        engine, and for any strategy with ``permute=True`` (prefetch and the
        segmented sharded engine route the state back to the ORIGINAL basis
        inside their own plans, so they relabel here only when asked; the
        segmented engine not even then, as in the JAX package)."""
        n = circuit.num_qubits
        perm = None
        work = circuit
        if not self._shard_segmented(n) and (
                self.config.permute or self.config.strategy in (
                    "mxu", "pallas", "vmem", "sharded")):
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

    def _restore(self, re, im, perm, residual):
        """Compose the relabeling with any layout the engine left behind,
        and undo both with one device unpermute (on the shards, without a
        join, for a sharded state)."""
        total = None
        if perm is not None and residual is not None:
            total = residual[perm]
        elif perm is not None:
            total = perm
        elif residual is not None:
            total = residual
        if total is not None and not np.array_equal(total,
                                                    np.arange(len(total))):
            total = [int(p) for p in total]
            if is_sharded(re):
                from ..parallel.sharded import unpermute_sharded

                return unpermute_sharded(re, im, total,
                                         self.mesh().device_list)
            re, im = A.unpermute_device(re, im, total)
        return re, im

    @_entry
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
        # queued, not waited for: a flat state's join readies the host's
        # output while the card runs and waits itself (ops/apply.py)
        re, im, num_ops = self._run_device(circuit, initial)
        if is_sharded(re):
            _synchronize(re, self.device)
        state = _join(re, im)
        return RunResult(
            state, circuit.num_qubits, len(circuit), num_ops,
            time.perf_counter() - t0, self.config.strategy,
        )

    # ------------------------------------------------------------- dispatch
    def _execute(self, circuit: Circuit, initial=None):
        cfg = self.config
        n = circuit.num_qubits
        if cfg.strategy in PER_GATE_STRATEGIES:
            return self._run_per_gate(circuit, initial)
        if cfg.strategy == "sharded":
            parts = None if initial is None else (initial.real, initial.imag)
            if self._shard_segmented(n):
                from ..parallel.sharded_prefetch import run_sharded_prefetch

                return run_sharded_prefetch(circuit, cfg, self.mesh(),
                                            initial_parts=parts)
            from ..parallel.sharded import run_sharded

            return run_sharded(circuit, cfg, self.mesh(), initial_parts=parts)
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
            return run_megakernel(ops, n, self.device, initial,
                                  _real_dtype(cfg))
        if cfg.strategy == "vmem":
            return self._run_vmem(circuit, initial)
        return self._run_mxu(circuit, initial)

    def _run_per_gate(self, circuit: Circuit, initial=None):
        """The reference's ablation rows (the JAX package's order and op
        counts): ``naive`` and ``fused3in1`` on the raw gates, ``fused2x2``
        and ``scan`` on ``fuse_2x2``'s ops, ``fused4x4`` on ``fuse_4x4``'s,
        each one dispatch of torch ops per gate, op or table row, at every
        width."""
        from . import naive

        cfg = self.config
        n = circuit.num_qubits
        re, im = self._start(n, initial)
        if cfg.strategy == "naive":
            re, im = naive.run_naive(circuit, re, im)
            return re, im, len(circuit), None
        if cfg.strategy == "fused3in1":
            re, im = naive.run_3in1(circuit, re, im)
            return re, im, len(circuit), None
        if cfg.strategy == "fused4x4":
            from ..passes.fuse4x4 import fuse_4x4

            ops = fuse_4x4(circuit)
            re, im = naive.run_oplist(ops, n, re, im)
            return re, im, len(ops), None
        from ..passes.fuse2x2 import fuse_2x2

        ops = fuse_2x2(circuit)
        if cfg.strategy == "fused2x2":
            re, im = naive.run_oplist(ops, n, re, im)
        else:
            from .scan import run_scan

            re, im = run_scan(ops, n, re, im, bucket=cfg.scan_bucket)
        return re, im, len(ops), None

    def _run_vmem(self, circuit: Circuit, initial=None):
        """The vmem engine (8 <= n <= 19): plain fusion to blocks of <= 7
        low plus 2 high qubits, then one kernel-8 launch per chunk."""
        with telemetry.span("qsim/plan"):
            ops, prog = self._vmem_program(circuit)
        re, im = self._start(circuit.num_qubits, initial)
        re, im = prog(re, im)
        return re, im, len(ops), None

    def _vmem_program(self, circuit: Circuit):
        """(fused ops, VmemProgram), from the plan cache."""
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

        return _cached_plan(key, plan)

    def _start(self, n: int, initial=None):
        dtype = _real_dtype(self.config)
        if initial is None:
            return A.initial_state_parts(n, dtype=dtype, device=self.device)
        return A.split_state(initial, dtype=dtype, device=self.device)

    def _run_mxu(self, circuit: Circuit, initial=None):
        """The wide engine: cost-model fusion, then the WideProgram."""
        with telemetry.span("qsim/plan"):
            ops, prog = self._mxu_program(circuit)
        re, im = self._start(circuit.num_qubits, initial)
        re, im = prog(re, im)
        return re, im, len(ops), None

    def _mxu_program(self, circuit: Circuit):
        """(fused ops, WideProgram), from the plan cache."""
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
        key = (_circuit_fingerprint(circuit), n, cfg.dtype, precision, k,
               window, costm, str(self.device))

        def plan():
            ops = _fuse_pipeline(circuit, k, max_high=2, window=window,
                                 cost_model=costm)
            return ops, build_wide_program(ops, n, precision=precision,
                                           device=self.device,
                                           dtype=_real_dtype(cfg))

        return _cached_plan(key, plan)


# The reference's ablation rows: torch ops per gate, op or table row
# (engine/naive.py, engine/scan.py), at every width, IEEE fp32 whatever the
# rung (float64 for complex128).
PER_GATE_STRATEGIES = ("naive", "fused2x2", "fused3in1", "fused4x4", "scan")

# what runs complex128: the JAX package's float64 parity arms
COMPLEX128_STRATEGIES = ("mxu", "megakernel", "reference", "sharded") \
    + PER_GATE_STRATEGIES


def _real_dtype(cfg: SimulatorConfig) -> torch.dtype:
    """The state's float dtype for ``cfg.dtype`` (the JAX package's
    ``_init_real_dtype``)."""
    return torch.float64 if cfg.dtype == "complex128" else torch.float32


def _check_run(cfg: SimulatorConfig, n: int) -> None:
    """Raise for what the port's engines do not run: n > 30 outside the
    sharded strategy, complex128 on the float32-only kernel engines, vmem
    above n = 19 (the prefetch engine fences its width itself,
    engine/prefetch.py ``check_slice``)."""
    if n > 30 and cfg.strategy != "sharded":
        # fail BEFORE allocating, as the JAX package does
        raise ValueError(
            f"n = {n} exceeds the single-chip ceiling (n = 30); use "
            "strategy='sharded' over a mesh of devices")
    if cfg.dtype == "complex128" and cfg.strategy not in COMPLEX128_STRATEGIES:
        raise ValueError(
            f"strategy {cfg.strategy!r} is float32-only (its kernels run no "
            "float64, as the JAX package's Mosaic kernels); complex128 runs "
            "on the parity arms mxu, megakernel and reference (and the "
            "per-gate engines)")
    if cfg.strategy == "vmem" and n > VMEM_MAX_QUBITS:
        raise ValueError(
            f"vmem strategy holds the state in VMEM: n <= {VMEM_MAX_QUBITS} "
            f"(got {n}); use mxu")


# mxu plan cache: (circuit fingerprint, n, precision, fusion knobs, device)
# -> (fused ops, WideProgram), and the vmem engine's ("vmem", fingerprint,
# n, max_fused_qubits, device) -> (fused ops, VmemProgram), as in the JAX
# package; also ("prefetch", fingerprint, ...) -> (None, the layout-closed
# PrefetchProgram of ``_build_program``).  Entries hold device tables, so
# the limit stays small.
_MXU_PLAN_CACHE: dict = {}
_MXU_PLAN_CACHE_LIMIT = 8


def _join(re, im) -> np.ndarray:
    """A device state, flat or sharded, as one complex host vector."""
    if is_sharded(re):
        from ..parallel.sharded import join_shards

        return join_shards(re, im)
    return A.join_state(re, im)


def _synchronize(re, device: torch.device) -> None:
    """Wait for the device (every card of a sharded state)."""
    if is_sharded(re):
        from ..parallel.sharded import synchronize

        synchronize(re)
    elif device.type == "cuda":
        torch.cuda.synchronize(device)


def _cached_plan(key, plan):
    """``_MXU_PLAN_CACHE[key]``, made by ``plan()`` on a miss."""
    cached = telemetry.lookup(_MXU_PLAN_CACHE, key)
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
    with telemetry.span("qsim/fuse"):
        if _NATIVE_FUSE is None:
            from ..passes import native_fuse as nf

            _NATIVE_FUSE = nf if nf.available() else False
        # The native fuser requires max_qubits >= 2 (csrc/qsim_fuse.cpp
        # rejects smaller); clamping is harmless since fused blocks never
        # exceed n qubits.
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

        return fuse_k(fuse_4x4(circuit), max_qubits=max_qubits,
                      max_high=max_high, max_low=max_qubits if cost else None)


def simulate(circuit: Circuit, strategy: str = "mxu", device="cuda",
             **kwargs) -> np.ndarray:
    """One-shot convenience: final state in the original basis."""
    return Simulator(SimulatorConfig(strategy=strategy, **kwargs),
                     device=device).run(circuit)
