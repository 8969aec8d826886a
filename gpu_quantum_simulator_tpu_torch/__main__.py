"""CLI: simulate a QASM circuit file on the card.

The port of the JAX package's ``__main__.py``, with the same flags, outputs
and exit codes.  The reference exposes nine binaries each taking
``<circuit_file>`` (and the CPU one ``<num_measurements>``,
quantum_simulator.c:39-42), printing elapsed seconds to stdout.  Here one
CLI covers every strategy:

    python -m gpu_quantum_simulator_tpu_torch circuit.qasm --strategy mxu -m 10

Output: one float (seconds) like the reference, then optional MEASUREMENT
lines (the reference's sampling loop exists but is commented out,
quantum_simulator.c:68-73 — here it works).

It runs on the CUDA card (``--device cuda``, the default) unless
``--device cpu`` is given; with no card and no ``--device cpu`` it exits
non-zero with the Simulator's error, and nothing falls back to the CPU.
``--trace DIR`` writes a torch.profiler trace (Chrome JSON) into DIR.
Noisy trajectory sampling (``--noise-*``) runs one batched ensemble
(``dynamic.sample_noisy``) on the same device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .config import STRATEGIES, SimulatorConfig
from .qasm.parser import parse_qasm_file


def _putb(n: int, length: int) -> str:
    """Binary rendering, MSB first (ref: putb, quantum_simulator.c:285-293)."""
    return format(n, f"0{length}b")


def _run_split_state(sim, circuit, args, cfg) -> int:
    """CLI path for the in-place split-state engine (n >= 30, or forced
    ``prefetch_inplace``): the flat 2^n state is never materialized — top
    amplitudes, sampling, marginals, entropy, and Pauli expectations all
    reduce on the four column halves."""
    n = circuit.num_qubits
    initial_parts = None
    if args.load_state:
        from .utils.checkpoint import load_state_halves

        try:
            initial_parts, meta = load_state_halves(args.load_state)
        except ValueError as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 1
        if int(meta["num_qubits"]) != n:
            print(f"ERROR: checkpoint has {meta['num_qubits']} qubits, "
                  f"circuit has {n}", file=sys.stderr)
            return 1

    t0 = time.perf_counter()
    try:
        parts, num_ops = sim.run_device_halves(
            circuit, initial_parts=initial_parts)
    except ValueError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    if args.save_state:
        from .utils.checkpoint import save_state_halves

        save_state_halves(args.save_state, *parts, n,
                          meta={"circuit": args.circuit,
                                "strategy": "prefetch"})
    from .sampling import norm_halves

    norm = float(norm_halves(*parts))
    seconds = time.perf_counter() - t0

    if args.json:
        print(json.dumps({
            "circuit": args.circuit, "num_qubits": n,
            "num_gates": len(circuit.gates), "num_fused_ops": num_ops,
            "strategy": "prefetch", "split_state": True,
            "norm": norm, "seconds": seconds,
        }))
    else:
        print(f"{seconds:.6f}")

    if args.amplitudes:
        from .sampling import amplitudes_halves, top_amplitudes_halves

        idx, probs = top_amplitudes_halves(*parts, k=args.amplitudes)
        amps = amplitudes_halves(*parts, idx)
        for i, pv, a in zip(idx, probs, amps):
            print(f"|{_putb(int(i), n)}>  p={pv:.6f}  "
                  f"amp={a.real:+.6f}{a.imag:+.6f}i")

    if args.expectation:
        from .observables import expectation_pauli

        for pauli in args.expectation:
            try:
                val = expectation_pauli(circuit, pauli, cfg,
                                        device=sim.device)
            except ValueError as exc:
                print(f"ERROR in Pauli string {pauli!r}: {exc}",
                      file=sys.stderr)
                return 1
            print(f"EXPECTATION {pauli}: {val:+.9f}")

    if args.marginal:
        from .observables import marginal_probabilities_halves

        for spec in args.marginal:
            try:
                qs = [int(t) for t in spec.split(",") if t.strip()]
                dist = marginal_probabilities_halves(*parts, qs, n)
            except ValueError as exc:
                print(f"ERROR in --marginal {spec!r}: {exc}", file=sys.stderr)
                return 1
            for i, pv in enumerate(dist):
                print(f"MARGINAL {spec} |{_putb(i, len(qs))}>: {pv:.6f}")

    if args.entropy_cut:
        from .observables import entanglement_entropy_halves

        try:
            s = entanglement_entropy_halves(*parts, args.entropy_cut, n)
        except ValueError as exc:
            print(f"ERROR in --entropy-cut: {exc}", file=sys.stderr)
            return 1
        print(f"ENTROPY cut={args.entropy_cut}: {s:.6f} bits")

    if args.measurements:
        from .sampling import sample_halves

        outcomes = sample_halves(*parts, n, args.measurements, args.seed)
        for o in outcomes:
            print(f"MEASUREMENT: {_putb(int(o), n)} ({int(o)})")
    return 0


class _Trace:
    """``--trace DIR``: a torch.profiler trace of the run, written as
    Chrome JSON (``trace.json``) into DIR when the run ends."""

    def __init__(self, path: str, device):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.path = path
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def close(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.path, "trace.json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu_quantum_simulator_tpu_torch")
    p.add_argument("circuit", help="OpenQASM 2/3 circuit file")
    p.add_argument("-m", "--measurements", type=int, default=0)
    p.add_argument("--strategy", choices=STRATEGIES, default="mxu")
    p.add_argument("--dtype", choices=["complex64", "complex128"], default="complex64")
    p.add_argument("--permute", action="store_true", help="qubit-relabeling pass")
    p.add_argument(
        "--precision", choices=["auto", "highest", "high", "default"],
        default="auto",
        help="matmul precision rung: highest = IEEE fp32 (the parity rung), "
        "high = the 3-pass bf16 product on the tensor cores, default = one "
        "bf16 pass (smoke runs only); auto (the default) = highest below 24 "
        "qubits, high from there up",
    )
    p.add_argument("--seed", type=int, default=0, help="measurement RNG seed")
    p.add_argument(
        "--inplace", action="store_true",
        help="force the in-place split-state prefetch engine (automatic at "
        "n >= 30); outputs reduce on the column halves, never a flat 2^n "
        "state (requires --strategy prefetch)",
    )
    p.add_argument(
        "--json", action="store_true", help="emit a structured JSON record instead"
    )
    p.add_argument(
        "--amplitudes", type=int, default=0, metavar="K",
        help="print the K largest-probability amplitudes",
    )
    p.add_argument("--save-state", metavar="PATH", help="checkpoint the final state (.npz)")
    p.add_argument("--load-state", metavar="PATH", help="resume from a checkpointed state")
    p.add_argument(
        "--expectation", metavar="PAULI", action="append", default=[],
        help='print <P> for a Pauli string, e.g. "Z0 Z1" or "XIZ" (repeatable)',
    )
    p.add_argument(
        "--marginal", metavar="QUBITS", action="append", default=[],
        help='print the outcome distribution over a qubit subset, e.g. '
        '"0,3,5" (little-endian in the given order; repeatable)',
    )
    p.add_argument(
        "--entropy-cut", type=int, default=0, metavar="K",
        help="print the von Neumann entanglement entropy (bits) of "
        "qubits [0, K)")
    p.add_argument(
        "--noise-p1", type=float, default=0.0,
        help="per-1q-gate noise probability (trajectory sampling; needs -m)")
    p.add_argument(
        "--noise-p2", type=float, default=0.0,
        help="per-2q-gate noise probability, applied to both qubits")
    p.add_argument(
        "--noise-kind", default="depolarizing",
        choices=["depolarizing", "dephasing", "bit_flip", "amplitude_damping"])
    p.add_argument(
        "--noise-correlated", action="store_true",
        help="2q-gate noise as ONE correlated depolarizing2 event on the "
        "pair instead of independent per-qubit events")
    p.add_argument(
        "--noise-readout", type=float, default=0.0, metavar="P",
        help="classical readout error: each outcome bit flips w.p. P")
    p.add_argument(
        "--trace", metavar="DIR",
        help="write a torch.profiler trace of the run (Chrome JSON, "
        "trace.json) into DIR")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the state lives and the kernels run: cuda = the card "
        "(the default; an error without one), cpu = each kernel's plain "
        "torch version on the host")
    args = p.parse_args(argv)

    try:
        circuit = parse_qasm_file(args.circuit)
    except (OSError, ValueError) as exc:
        print(f"ERROR while parsing quantum circuit: {exc}", file=sys.stderr)
        return 1

    # --load-state is resolved AFTER the execution path is chosen: the
    # split-state engine loads column-half checkpoints, the flat engines
    # load flat ones (see below)

    cfg = SimulatorConfig(
        strategy=args.strategy, dtype=args.dtype, permute=args.permute,
        precision=args.precision,
        prefetch_inplace=True if args.inplace else None,
    )

    noisy = (args.noise_p1 > 0.0 or args.noise_p2 > 0.0
             or args.noise_readout > 0.0)
    if noisy:
        # noisy runs are trajectory ensembles: amplitudes are not a
        # single-state concept there, only measurement statistics are
        if not args.measurements:
            print("ERROR: --noise-* requires -m (trajectory sampling)",
                  file=sys.stderr)
            return 1
        for flag, val in (("--amplitudes", args.amplitudes),
                          ("--expectation", args.expectation),
                          ("--save-state", args.save_state),
                          ("--load-state", args.load_state)):
            if val:
                print(f"ERROR: {flag} is not available with --noise-*",
                      file=sys.stderr)
                return 1
        from .dynamic import sample_noisy
        from .ops.apply import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        try:
            outcomes = sample_noisy(
                circuit, args.measurements, kind=args.noise_kind,
                p1=args.noise_p1, p2=args.noise_p2, seed=args.seed,
                config=cfg, correlated=args.noise_correlated,
                readout_error=args.noise_readout, device=device)
        except NotImplementedError as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 1
        seconds = time.perf_counter() - t0
        if args.json:
            print(json.dumps({
                "circuit": args.circuit,
                "num_qubits": circuit.num_qubits,
                "num_gates": len(circuit.gates),
                "strategy": cfg.strategy,
                "noise": {"kind": args.noise_kind, "p1": args.noise_p1,
                          "p2": args.noise_p2,
                          "correlated": args.noise_correlated,
                          "readout": args.noise_readout},
                "seconds": seconds,
            }))
        else:
            print(f"{seconds:.6f}")
        for o in outcomes:
            print(f"MEASUREMENT: {_putb(int(o), circuit.num_qubits)} ({int(o)})")
        return 0

    from .engine.simulator import Simulator

    try:
        sim = Simulator(cfg, device=args.device)
    except RuntimeError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    trace = _Trace(args.trace, sim.device) if args.trace else None
    try:
        return _run(sim, circuit, args, cfg, trace)
    except NotImplementedError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    finally:
        if trace is not None:
            trace.close()


def _run(sim, circuit, args, cfg, trace) -> int:
    rsim = sim._resolved(circuit.num_qubits)
    if (rsim.config.strategy == "prefetch"
            and rsim._prefetch_inplace(circuit.num_qubits)):
        return _run_split_state(rsim, circuit, args, cfg)

    initial = None
    if args.load_state:
        from .utils.checkpoint import load_state

        re0, im0, meta = load_state(args.load_state)
        if meta["num_qubits"] != circuit.num_qubits:
            print(
                f"ERROR: checkpoint has {meta['num_qubits']} qubits, "
                f"circuit has {circuit.num_qubits}", file=sys.stderr,
            )
            return 1
        initial = re0 + 1j * im0

    res = sim.run_detailed(circuit, initial=initial)

    if trace is not None:
        trace.close()

    if args.save_state:
        from .utils.checkpoint import save_state

        save_state(
            args.save_state, res.state.real, res.state.imag, res.num_qubits,
            meta={"circuit": args.circuit, "strategy": res.strategy},
        )

    if args.json:
        print(
            json.dumps(
                {
                    "circuit": args.circuit,
                    "num_qubits": res.num_qubits,
                    "num_gates": res.num_gates,
                    "num_fused_ops": res.num_fused_ops,
                    "strategy": res.strategy,
                    "seconds": res.seconds,
                }
            )
        )
    else:
        print(f"{res.seconds:.6f}")

    if args.amplitudes:
        import numpy as np

        p2 = np.abs(res.state) ** 2
        for idx in np.argsort(-p2)[: args.amplitudes]:
            amp = res.state[idx]
            print(
                f"|{_putb(int(idx), res.num_qubits)}>  p={p2[idx]:.6f}  "
                f"amp={amp.real:+.6f}{amp.imag:+.6f}i"
            )

    if args.expectation:
        from .observables import expectation_pauli

        for pauli in args.expectation:
            try:
                val = expectation_pauli(circuit, pauli, cfg,
                                        device=sim.device)
            except ValueError as exc:
                print(f"ERROR in Pauli string {pauli!r}: {exc}", file=sys.stderr)
                return 1
            print(f"EXPECTATION {pauli}: {val:+.9f}")

    if args.marginal or args.entropy_cut:
        from .ops.apply import split_state

        # the port's observables on torch tensors, on the simulator's device
        re_d, im_d = split_state(res.state, device=sim.device)
        if args.marginal:
            from .observables import marginal_probabilities

            for spec in args.marginal:
                try:
                    qs = [int(t) for t in spec.split(",") if t.strip()]
                    dist = marginal_probabilities(re_d, im_d, qs, res.num_qubits)
                except ValueError as exc:
                    print(f"ERROR in --marginal {spec!r}: {exc}",
                          file=sys.stderr)
                    return 1
                for i, pv in enumerate(dist):
                    print(f"MARGINAL {spec} |{_putb(i, len(qs))}>: {pv:.6f}")
        if args.entropy_cut:
            from .observables import entanglement_entropy

            try:
                s = entanglement_entropy(re_d, im_d, args.entropy_cut,
                                         res.num_qubits)
            except ValueError as exc:
                print(f"ERROR in --entropy-cut: {exc}", file=sys.stderr)
                return 1
            print(f"ENTROPY cut={args.entropy_cut}: {s:.6f} bits")

    if args.measurements:
        import numpy as np

        from .ref.cpu import sample

        outcomes = sample(res.state, args.measurements, np.random.default_rng(args.seed))
        for o in outcomes:
            print(f"MEASUREMENT: {_putb(int(o), res.num_qubits)} ({int(o)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
