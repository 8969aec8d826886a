#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, check, run.

    python3 chip_smoke.py

Drives ``gpu_quantum_simulator_tpu_torch`` (never JAX, never the JAX
package) through its main path on the first CUDA device, in phases; any
failure raises and the script exits non-zero:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from the repository's sources (build/);
3. hold each kernel against its plain torch version on the card at the
   main path's shapes — the block kernel at n=18 on synthetic blocks
   covering mat, mono, perm v=0..6 and tswap k=1..9 in plain and steered
   form (max |diff| <= 1e-5), the relayout kernel at n=22 with a random
   sigma (bit-exact) — and time both on the device (CUDA events);
4. run ``Simulator(SimulatorConfig(strategy="prefetch"), device="cuda")
   .run_detailed`` on ``grover_like(n, 2445, 318)`` at n=18 and n=22: one
   warm-up, five timed runs; hold the state to the native f64 reference
   (max |diff| <= 1e-6, norm within 1e-4 of 1) and the kernels' launch
   counts to > 0 (block at both widths, relayout at n=22).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Matmuls in plain torch run in IEEE
fp32: TF32 is switched off for both matmul and cuDNN.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BLOCK_TOL = 1e-5      # kernel vs plain torch, fp32 sums in another order
AMP_TOL = 1e-6        # main path vs the f64 native reference
NORM_TOL = 1e-4
WIDTHS = (18, 22)
TIMED_RUNS = 5
SPIN_CYCLES = 200_000_000   # ~0.1 s at 2 GHz: covers queuing 20 calls
BLOCK_SRC = "gpu_quantum_simulator_tpu_torch/csrc/prefetch_block.cu"
RELAYOUT_SRC = "gpu_quantum_simulator_tpu_torch/csrc/relayout.cu"
BLOCK_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1214"
RELAYOUT_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1586"


def device_ms(torch, fn, reps=20, rounds=5):
    """Median over ``rounds`` of the mean device milliseconds of ``fn``.

    CUDA events bracket ``reps`` calls queued behind a spin kernel, so the
    host's launch overhead is hidden and the events time the device work
    alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def random_unitary(rng, d):
    q, r = np.linalg.qr(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_monomial(rng, d):
    u = np.zeros((d, d), dtype=complex)
    u[np.arange(d), rng.permutation(d)] = np.exp(
        1j * rng.uniform(-np.pi, np.pi, d))
    return u


def synthetic_blocks(PF, rng, logt):
    """Blocks covering every step kind, plain and steered (n=18 geometry:
    one tile bit above the T=512 tile, so the prologue swaps tile bit 0)."""
    def mat(width, mono=False, operm=None):
        d = 1 << width
        u = random_monomial(rng, d) if mono else random_unitary(rng, d)
        pos = tuple(int(p) for p in rng.permutation(PF.LOCAL_QUBITS)[:width])
        return (u, pos, operm)

    kind_perm, kind_mono = logt + 1, logt + 2
    full = PF._Block()
    steps = ([(0, mat(7)), (kind_mono, mat(5, mono=True))]
             + [(kind_perm, v) for v in range(PF.LANE_QUBITS)]
             + [(k, 0) for k in range(1, logt + 1)]
             + [(0, mat(3, operm=PF._window_swap_index(2))),
                (kind_mono, mat(7, mono=True))])
    for kind, arg in steps:
        full.kinds.append(kind)
        if kind in (0, kind_mono):
            full.midx.append(len(full.mats))
            full.mats.append(arg)
        else:
            full.midx.append(arg)
    blocks = [full]
    for first in ((0, mat(6)), (kind_mono, mat(4, mono=True)),
                  (kind_perm, 3), (logt, 0), None):
        b = PF._Block(prologue=(1, 0))
        if first is not None:
            kind, arg = first
            b.kinds += [kind, 0]
            if kind in (0, kind_mono):
                b.midx += [0, 1]
                b.mats += [arg, mat(2)]
            else:
                b.midx += [arg, 0]
                b.mats += [mat(2)]
        blocks.append(b)
    return blocks


def check_block_kernel(torch, rng):
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, run_block_plain)

    n = 18
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    logt = int(np.log2(PF.tile_rows(n)))
    blocks = synthetic_blocks(PF, rng, logt)
    groups = PF.materialize_entries(blocks, PF.CAP_STEPS, PF.CAP_MATS,
                                    np.float32)
    assert len(groups) == 1, "synthetic blocks must share one table group"
    (_, _, scal, *tabs) = groups[0]
    a_tab, b_tab, mono_src = PF.expand_tables(
        *(torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in tabs))
    re = torch.from_numpy(rng.standard_normal((R2, 256)).astype(np.float32)).cuda()
    im = torch.from_numpy(rng.standard_normal((R2, 256)).astype(np.float32)).cuda()
    err = 0.0
    for i in range(len(blocks)):
        args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
        got = run_block(scal[i], re.clone(), im.clone(), *args)
        want = run_block_plain(scal[i], re, im, *args)
        torch.cuda.synchronize()
        e = max(float((got[0] - want[0]).abs().max()),
                float((got[1] - want[1]).abs().max()))
        print(f"block kernel n={n} entry {i} steps={int(scal[i][0])} "
              f"steered={int(scal[i][1]) == 1}: max|diff| {e:.3e}")
        if not e <= BLOCK_TOL:
            raise AssertionError(f"block kernel entry {i}: {e} > {BLOCK_TOL}")
        err = max(err, e)
    scratch = (torch.empty_like(re), torch.empty_like(im))
    args = (a_tab[0], b_tab[0], mono_src[0], logt, PF.CAP_STEPS)
    ms = device_ms(torch, lambda: run_block(scal[0], re, im, *args,
                                          scratch=scratch))
    plain_ms = device_ms(torch, lambda: run_block_plain(scal[0], re, im, *args))
    print(f"block kernel n={n}, {int(scal[0][0])}-step block: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    mat_step_timing(torch, PF, rng, run_block, run_block_plain)
    return {"name": "prefetch_block", "route": "cuda", "source": BLOCK_SRC,
            "replaces": BLOCK_TPU, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def mat_step_timing(torch, PF, rng, run_block, run_block_plain):
    """One-mat-step block at n=22 shapes (the fp32-bound step)."""
    n = 22
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    blk = PF._Block(kinds=[0], midx=[0],
                    mats=[(random_unitary(rng, 128), tuple(range(7)), None)])
    (_, _, scal, *tabs), = PF.materialize_entries(
        [blk], PF.CAP_STEPS, 2, np.float32)
    a_tab, b_tab, mono_src = PF.expand_tables(
        *(torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in tabs))
    re = torch.randn(R2, 256, device="cuda")
    im = torch.randn(R2, 256, device="cuda")
    logt = int(np.log2(PF.tile_rows(n)))
    args = (a_tab[0], b_tab[0], mono_src[0], logt, PF.CAP_STEPS)
    got = run_block(scal[0], re, im, *args)
    want = run_block_plain(scal[0], re, im, *args)
    torch.cuda.synchronize()
    e = float(max((got[0] - want[0]).abs().max(), (got[1] - want[1]).abs().max()))
    if not e <= BLOCK_TOL:
        raise AssertionError(f"mat step n=22: {e} > {BLOCK_TOL}")
    scratch = (torch.empty_like(re), torch.empty_like(im))
    ms = device_ms(torch, lambda: run_block(scal[0], re, im, *args,
                                          scratch=scratch))
    plain_ms = device_ms(torch, lambda: run_block_plain(scal[0], re, im, *args))
    flop = 8.0 * R2 * 256 * 256
    print(f"mat step n={n}: kernel {ms:.4f} ms ({flop / ms / 1e9:.2f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms ({flop / plain_ms / 1e9:.2f} "
          f"TFLOP/s), max|diff| {e:.3e}")


def check_relayout_kernel(torch, rng):
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.relayout import (
        run_relayout, run_relayout_plain)

    n = 22
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    tr = PF.relayout_rows(n)
    m = int(np.log2(R2 // tr))
    sigma = rng.permutation(m).astype(np.int32)
    re = torch.randn(R2, 256, device="cuda")
    im = torch.randn(R2, 256, device="cuda")
    got = run_relayout(sigma, re, im, tr)
    want = run_relayout_plain(sigma, re, im, tr)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("relayout kernel differs from its plain version")
    out = (torch.empty_like(re), torch.empty_like(im))
    ms = device_ms(torch, lambda: run_relayout(sigma, re, im, tr, out=out))
    plain_ms = device_ms(torch, lambda: run_relayout_plain(sigma, re, im, tr))
    gbs = 4 * re.numel() * 4 / (ms * 1e-3) / 1e9
    print(f"relayout kernel n={n} sigma={sigma.tolist()}: bit-exact; kernel "
          f"{ms:.4f} ms ({gbs:.0f} GB/s), plain {plain_ms:.4f} ms")
    return {"name": "relayout", "route": "cuda", "source": RELAYOUT_SRC,
            "replaces": RELAYOUT_TPU, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms}


def run_main_path(torch, T):
    from gpu_quantum_simulator_tpu_torch.kernels.block import run_block
    from gpu_quantum_simulator_tpu_torch.kernels.relayout import run_relayout
    from gpu_quantum_simulator_tpu_torch.ref.native import simulate_native

    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cuda")
    run_block.launches = 0
    run_relayout.launches = 0
    counts = {}
    for n in WIDTHS:
        before = (run_block.launches, run_relayout.launches)
        c = T.models.grover_like(n, 2445, 318)
        warm = sim.run_detailed(c)
        runs = [sim.run_detailed(c) for _ in range(TIMED_RUNS)]
        secs = [r.seconds for r in runs]
        res = runs[-1]
        want = simulate_native(c)
        err = float(np.max(np.abs(res.state - want)))
        norm = float(np.linalg.norm(res.state))
        counts[n] = (run_block.launches - before[0],
                     run_relayout.launches - before[1])
        print(f"main path n={n}: {res.num_fused_ops} steps from "
              f"{res.num_gates} gates; warm-up {warm.seconds:.4f} s; "
              f"run_detailed median {np.median(secs):.4f} s "
              f"(min {min(secs):.4f}, runs {[round(s, 4) for s in secs]}); "
              f"max|amp - f64| {err:.3e}; norm {norm:.8f}; launches "
              f"block {counts[n][0]} relayout {counts[n][1]}")
        if not (res.state.shape == (1 << n,) and np.isfinite(res.state).all()):
            raise AssertionError(f"n={n}: state is not finite of shape 2^n")
        if not err <= AMP_TOL:
            raise AssertionError(f"n={n}: max|amp diff| {err} > {AMP_TOL}")
        if not abs(norm - 1.0) <= NORM_TOL:
            raise AssertionError(f"n={n}: norm {norm}")
        if counts[n][0] <= 0:
            raise AssertionError(f"n={n}: the block kernel never launched")
    if counts[22][1] <= 0:
        raise AssertionError("n=22: the relayout kernel never launched")
    return run_block.launches, run_relayout.launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import gpu_quantum_simulator_tpu_torch as T
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    # phase 2: build every kernel from the checkout's sources, and the
    # native host libraries the main path and its reference use
    from gpu_quantum_simulator_tpu_torch.kernels import build
    from gpu_quantum_simulator_tpu_torch.passes import native_fuse
    from gpu_quantum_simulator_tpu_torch.ref import native

    t0 = time.perf_counter()
    build.load()
    built = build.last_build
    print(f"kernels built in {time.perf_counter() - t0:.2f} s"
          + ("" if built else " (already built)"))
    if built:
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    native_fuse.get_lib()
    native.get_lib()

    # phase 3: each kernel against its plain version
    rng = np.random.default_rng(2445)
    block = check_block_kernel(torch, rng)
    relayout = check_relayout_kernel(torch, rng)

    # phase 4: the main path, counting launches
    block["launches"], relayout["launches"] = run_main_path(torch, T)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in (block, relayout)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
