#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, check, run.

    python3 chip_smoke.py

Drives ``gpu_quantum_simulator_tpu_torch`` (never JAX, never the JAX
package) through its main paths on the first CUDA device, in phases; any
failure raises and the script exits non-zero:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from the repository's sources (build/);
3. hold each kernel against its plain torch version on the card at the
   main path's shapes — the block kernel at n=18 on synthetic blocks
   covering mat, mono, perm v=0..6 and tswap k=1..9 in plain and steered
   form (max |diff| <= 1e-5) and its fp32 mat step at n=22, the relayout
   kernel at n=22 with a random sigma (bit-exact), the folded-relayout
   input (scal mode 5) at n=24 with a random sigma over the 10 row-block
   bits and a mat, tswap or perm first step (gather-first bit-exact,
   mat-first <= 1e-5, both rungs), the "high" rung's mat step (bf16 tensor
   cores) at n=24 and n=28 (<= 1e-5), and the lane-layout chain kernel at
   n=24 on a normalized state: chains of P = 1 and 8 products at both
   rungs (<= 1e-7; in place bit-exact) and one product as
   ``apply_block128`` (<= 1e-7), and the vmem chunk kernel (kernel 8) at
   n=18 on a normalized state with the first 96-op chunk of the benchmark
   circuit's vmem fusion (<= 1e-7; the same chunk with one op's imaginary
   products dropped must miss that bar; timed also as 96 one-op launches,
   against its grid barriers) and on one D=512 op — and time each
   on the device (CUDA events) beside its bound and, where one exists, one
   PyTorch call computing the same function.  A bound counts the least work the
   function needs: a complex product as three real products (Karatsuba,
   as the TPU kernels compute it), each three bf16 passes at "high";
4. run each strategy's ``Simulator(..., device="cuda").run_detailed`` on
   ``grover_like(n, 2445, 318)``, each width's launch counts set to 0 just
   before it runs and read just after, checked against its plan.
   prefetch ("prefetch"|"auto"): n=18, 22 and 23 (one warm-up, five timed
   runs) against the native f64 reference (computed once per width and
   shared by every strategy; max |diff| <= 1e-6, norm within 1e-4 of 1);
   n=24 at the "high" rung "auto" resolves to against the port's own
   "highest" run (<= 4e-6); n=28 (one warm-up, three timed runs; norm) and
   its mirror circuit ``c.compose(c.inverse())`` at "highest", whose
   |0...0> amplitude must be within 1e-5 of 1.  Block launches > 0,
   relayout launches equal to the plan's standalone relayouts (scal mode
   3) per run, folded first launches > 0 from n=23, "high" mat launches > 0
   at 24 and 28.  mxu (the default config): n=18 and 22 against the f64
   reference (<= 1e-6); n=24 "auto" ("high") against its own "highest" run
   (> 0, <= 4e-6), that "highest" run against the prefetch one (<= 1e-6);
   the low-only circuit (600 gates on qubits 0..6) at n=24 with
   max_fused_qubits=3 (nine chains of P = 8 per run: launches equal the
   plan's kh0 runs) against the same circuit at max_fused_qubits=7 (one
   P = 1 chain) at "highest" (<= 1e-6) and "high" (the rung's bar scaled
   to the state's peak amplitude); ``Simulator(device="cuda")`` with the
   default config.  pallas: n=18 and 22 against the f64 reference
   (<= 1e-6), kernel-9 launches equal to the plan's mat items per run.
   vmem: n=18 and 19 (one warm-up, five timed runs) against the f64
   reference (<= 1e-6, norm within 1e-4), kernel-8 launches equal to the
   plan's chunks per run and no other kernel launched.  The small widths:
   mxu, pallas, prefetch, vmem and megakernel at n=2..8 on
   ``grover_like(n, 200, 318)`` and ``strategy="megakernel"`` at n=18,
   each within 1e-6 of the f64 reference; the megakernel arm (n <= 7,
   prefetch at n = 8, the megakernel strategy) launches no port kernel,
   vmem at n = 8 one per chunk.

5. the in-place split-state prefetch engine (four column halves, no
   second state buffer).  Kernel checks at n=24 on halves: a block of every
   step kind (kernel 5(a)) against its plain version and against the flat
   block kernel on the joined state (index steps bit-exact, the fp32 mat
   step <= 1e-6, the "high" one <= 1e-5), the pair swap (kernel 5(b)) on
   two tile bits (bit-exact), pair mode (kernel 6) with a mat first step at
   both rungs and a tswap, perm or mono first step against "pair swap, then
   the plain block" (bit-exact for the gathers; a plain version without its
   imaginary-table products must miss the mat bar), and the in-place
   relayout (kernel 4) on an involution with and without fixed blocks
   (bit-exact), each timed beside its bound and a PyTorch call.  The path
   with ``prefetch_inplace=True``: n=9..17 at both rungs ("highest" against
   the f64 reference, "high" by its norm); then, prologues hoisted (the
   Simulator) and folded (``fold_xswap``, through
   ``build_prefetch_program``): n=18, 22, 23 against the f64 reference
   (<= 1e-6), n=24 "high" against its "highest" run (> 0, <= 4e-6),
   launches by kind equal to the plan's scal rows by mode with
   every flat kernel's count 0, and ``run_device_halves`` joined equal to
   ``run_device`` bit for bit.  Sampling: 200 000 samples at n=23 (flat)
   and n=22 (halves) by chi-square over 4096 bins against the f64
   probabilities; ``expectation_z(_halves)`` and ``top_amplitudes_*``
   against the f64 state.  Full width: n=30 with
   ``SimulatorConfig(strategy="prefetch")`` alone (in place, "high")
   through ``run_device_halves`` — norm within 1e-4 of 1, peak device
   memory <= the state's 8 GiB + 2 GiB, amplitudes at the top-64 and 4096
   random indices against the flat run of the same circuit
   (``prefetch_inplace=False``, peak above 16 GiB), and
   ``Simulator.sample`` reproducible from its seed.  A resume at n=22:
   ``run_device_halves(second, initial_parts=...)`` from the device halves
   of a run of the circuit's first 1200 gates and from their flat pair,
   equal to each other and within 1e-6 of the f64 reference.
6. the public op and the probes no engine calls (as in the JAX package).
   Kernel 10, ``ops/pallas_kernels.py`` ``apply_butterfly_high`` at n=30:
   three random unitaries on row bits 0, 11 and 22 of a normalised state
   against its plain version (<= 1e-6), in place against out of place
   (bit-exact), timed beside its bound, the plain version and
   ``ops/apply.py`` ``apply_1q``.  Kernel 11, the copy probe harness
   (``dma_probe.py``) at n = 24, 28 and 30: every route (grid, stream,
   direct TMA) and tile shape copies bit for bit; GB/s beside ``copy_``'s.

Phase 3 also pins the "high" mat step's norm drift: 200 chained steps at
n=24 on a normalised random state over eight random unitary tables, for
six seeds, the drift printed after every step for the kernel and its plain
version; after 200 steps the kernel's largest |1 - norm| over the seeds may
be at most 3 times the plain version's largest, and on every seed the
kernel's drift may differ from the plain version's by at most 2e-6.  At
n=30 (phase 5) ``norm_halves`` must be within 1e-5 of 1.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Matmuls in plain torch run in IEEE
fp32: TF32 is switched off for both matmul and cuDNN.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np

BLOCK_TOL = 1e-5      # kernel vs plain torch, fp32 sums in another order
AMP_TOL = 1e-6        # main path vs the f64 native reference
NORM_TOL = 1e-4
HIGH_TOL = 4e-6       # "high" vs "highest" (the JAX rung's bar,
                      # tests/test_precision_auto.py)
CHAIN_TOL = 1e-7      # chain kernel vs its plain version on a normalized
                      # n=24 state, both rungs: the same arithmetic in
                      # another order (readings <= 1.2e-8 on an H100); a
                      # dropped bf16 pass errs by ~1e-6
HIGH_BAR_PEAK = 0.0486  # peak |amp| of grover_like(12, 600, 41), the state
                        # HIGH_TOL was set on: the bar scales with a state's
                        # peak (tests/test_torch_wide.py high_tol)
MIRROR_TOL = 1e-5     # |<0|C^-1 C|0>| at "highest", n=28
VMEM_TOL = 1e-7       # vmem chunk kernel vs its plain version on a
                      # normalized n=18 state: the same four fp32 products
                      # per op in another order (readings <= 2.8e-9 on an
                      # H100); a dropped product errs by ~1e-3
REF_WIDTHS = (18, 22, 23)   # main path held to the f64 reference
VMEM_WIDTHS = (18, 19)      # vmem against the f64 reference
SMALL_WIDTHS = range(2, 9)  # every strategy's megakernel arm and above it
SMALL_STRATEGIES = ("mxu", "pallas", "prefetch", "vmem", "megakernel")
ENGINE_REF_WIDTHS = (18, 22)  # mxu and pallas against the same reference
HIGH_WIDTH = 24             # "high" held to the port's own "highest"
MIRROR_WIDTH = 28           # timed at "high"; mirror circuit at "highest"
FOLD_WIDTH = 24             # phase 3 geometry of the folded block
WIDE_WIDTH = 24             # phase 3 geometry of the chain kernel
LOW_ONLY = (24, 600, 3)     # (n, gates, seed) of the low-only circuit
HIGH_STEPS = ((24, 20), (28, 3))   # (n, timing reps) of the "high" mat step
DRIFT_WIDTH = 24            # the "high" mat step's norm drift, chained
DRIFT_STEPS = 200
DRIFT_SLOTS = 8             # table slots of one block entry (cap_mats 8)
DRIFT_SEEDS = (200, 201, 202, 203, 204, 205)  # one state and table set each
DRIFT_RATIO = 3.0           # the kernel's largest |1 - norm| after 200 steps
                            # over the seeds <= 3 x the plain version's
                            # largest (which differs from 0 by the rung's
                            # own rounding, and moves ~10x from seed to
                            # seed, so one seed's ratio is no measure)
DRIFT_EXCESS = 2e-6         # and on every seed the kernel's drift beyond
                            # the plain version's (signed) within 2e-6 after
                            # 200 steps: -5.9e-7..-6.7e-7 over the six seeds
                            # on an H100, against -5.9e-4 for one tensor-core
                            # accumulator
TIMED_RUNS = 5
ENGINE_RUNS = 3             # timed runs of mxu / pallas per width
SPIN_CYCLES = 200_000_000   # ~0.1 s at 2 GHz: covers queuing 20 calls
# published H100 SXM peaks at 700 W (NVIDIA data sheet), for the bounds
FP32_FLOPS = 67e12          # CUDA cores
BF16_FLOPS = 989e12         # dense tensor cores
HBM_BYTES = 3.35e12
BLOCK_SRC = "gpu_quantum_simulator_tpu_torch/csrc/prefetch_block.cu"
RELAYOUT_SRC = "gpu_quantum_simulator_tpu_torch/csrc/relayout.cu"
HIGH_SRC = "gpu_quantum_simulator_tpu_torch/csrc/mat_high.cu"
WIDE_SRC = "gpu_quantum_simulator_tpu_torch/csrc/wide_chain.cu"
VMEM_SRC = "gpu_quantum_simulator_tpu_torch/csrc/vmem_chunk.cu"
SPLIT_SRC = "gpu_quantum_simulator_tpu_torch/csrc/split_block.cu"
BLOCK_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1214"
RELAYOUT_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1586"
STREAM_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1376"
KH0_TPU = "gpu_quantum_simulator_tpu/engine/wide.py:43"
BLOCK128_TPU = "gpu_quantum_simulator_tpu/ops/pallas_kernels.py:54"
VMEM_TPU = "gpu_quantum_simulator_tpu/engine/vmem.py:62"
INPLACE_RELAYOUT_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1690"
SPLIT_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1824"
STREAM_SPLIT_TPU = "gpu_quantum_simulator_tpu/engine/prefetch.py:1952"
BUTTERFLY_SRC = "gpu_quantum_simulator_tpu_torch/csrc/butterfly_high.cu"
BUTTERFLY_TPU = "gpu_quantum_simulator_tpu/ops/pallas_kernels.py:116"
COPY_SRC = "gpu_quantum_simulator_tpu_torch/csrc/copy_probe.cu"
COPY_TPU = {"grid": "scripts/dma_probe.py:51",
            "stream": "scripts/dma_probe.py:82",
            "direct": "scripts/dma_probe.py:164"}
BUTTERFLY_WIDTH = 30        # kernel 10 at full width
BUTTERFLY_BITS = (0, 11, 22)
BUTTERFLY_TOL = 1e-6        # the kernel rounds each product and sum as the
                            # plain version does, in the same order
COPY_WIDTHS = (24, 28, 30)  # kernel 11's harness
SPLIT_WIDTH = 24            # phase 5 geometry of the in-place kernel checks
SPLIT_MAT_TOL = 1e-6        # in-place fp32 mat step vs plain, |x| ~ 1/16
INPLACE_WIDTHS = (18, 22, 23)   # in-place path held to the f64 reference
INPLACE_SMALL = range(9, 18)    # in place below the first cross-tile swap
RESUME_AT = 1200            # gate after which a run resumes from its state
FULL_WIDTH = 30             # the width where prefetch runs in place unasked
FULL_PEAK_SLACK = 2 << 30   # peak device memory allowed above the state
FULL_NORM_TOL = 1e-5        # n=30 norm_halves after its 692 "high" steps
SAMPLES = 200_000
SAMPLE_BINS = 4096


def norm2(pair):
    return float(sum((x.double() ** 2).sum() for x in pair))


def max_diff(got, want):
    return max(float((got[0] - want[0]).abs().max()),
               float((got[1] - want[1]).abs().max()))


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


def bound(flops=0.0, nbytes=0.0, rate=FP32_FLOPS):
    """(bound_ms, bound_by): the least time for the work on the card, the
    larger of its operations over the peak rate and its bytes over HBM."""
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def record(name, src, tpu, err, ms, plain_ms, bnd, library_ms):
    return {"name": name, "route": "cuda", "source": src, "replaces": tpu,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}


def bit_permute(x, src_of):
    """One copy of ``x`` (..., 2^m) whose flat bit b is bit ``src_of[b]``
    of the input: a reshape, one ``permute`` and ``contiguous`` — the
    library call beside the relayout and folded-input kernels.  Runs of
    bits that move together share a dim, so the view stays low-rank."""
    m = len(src_of)
    runs = []
    b = m - 1
    while b >= 0:
        src, width = src_of[b], 1
        while b - width >= 0 and src_of[b - width] == src - width:
            width += 1
        runs.append((src - width + 1, width))
        b -= width
    order = sorted(range(len(runs)), key=lambda r: -runs[r][0])
    lead = x.dim() - 1
    v = x.reshape(*x.shape[:-1], *(1 << runs[r][1] for r in order))
    perm = [order.index(r) + lead for r in range(len(runs))]
    return v.permute(*range(lead), *perm).reshape(x.shape)


def relayout_bits(n, tr, sigma):
    """src_of for the relayout: output bit b0 + sigma[a] is input b0 + a."""
    b0 = int(np.log2(tr)) + 8
    src = list(range(n))
    for a, s in enumerate(sigma):
        src[b0 + int(s)] = b0 + a
    return src


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
    # the block's least work: each mat step three real (R2, 256) @
    # (256, 256) products (Karatsuba) and its two tables, each mono step a
    # column gather and two table rows, the state read and written once
    kinds = [int(k) for k in scal[0][4 : 4 + int(scal[0][0])]]
    mats, monos = kinds.count(0), kinds.count(logt + 2)
    bnd = bound(6.0 * R2 * 256 * 256 * mats,
                16.0 * R2 * 256 + mats * 2 * 256 * 256 * 4
                + monos * 3 * 256 * 4)
    print(f"block kernel n={n}, {len(kinds)}-step block ({mats} mat, "
          f"{monos} mono): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    blk = record("prefetch_block", BLOCK_SRC, BLOCK_TPU, err, ms, plain_ms,
                 bnd, None)
    return blk, mat_step_timing(torch, PF, rng, run_block, run_block_plain)


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
    # one fp32 torch.matmul computing the same step: [re | im] @ [[A, B],
    # [-B, A]] = [re A - im B | re B + im A]
    x = torch.cat([re, im], 1)
    a, b = a_tab[0, 0], b_tab[0, 0]          # the entry's slot 0
    w = torch.cat([torch.cat([a, b], 1), torch.cat([-b, a], 1)], 0)
    lib = torch.matmul(x, w)
    torch.cuda.synchronize()
    e_lib = max_diff((lib[:, :256], lib[:, 256:]), got)
    if not e_lib <= BLOCK_TOL:
        raise AssertionError(f"mat step n=22 library call: {e_lib}")
    library_ms = device_ms(torch, lambda: torch.matmul(x, w))
    flop = 6.0 * R2 * 256 * 256      # three real products (Karatsuba)
    bnd = bound(flop, 16.0 * R2 * 256 + 2 * 256 * 256 * 4)
    print(f"mat step n={n}: kernel {ms:.4f} ms ({flop / ms / 1e9:.2f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms ({flop / plain_ms / 1e9:.2f} "
          f"TFLOP/s), fp32 torch.matmul {library_ms:.4f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), max|diff| {e:.3e}")
    return record("prefetch_mat_step", BLOCK_SRC, BLOCK_TPU, e, ms, plain_ms,
                  bnd, library_ms)


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
    pair = torch.stack([re.reshape(-1), im.reshape(-1)])
    src = relayout_bits(n, tr, sigma)
    lib = bit_permute(pair, src)
    if not (torch.equal(lib[0], got[0].reshape(-1))
            and torch.equal(lib[1], got[1].reshape(-1))):
        raise AssertionError("relayout: the permute-copy differs")
    library_ms = device_ms(torch, lambda: bit_permute(pair, src))
    gbs = 4 * re.numel() * 4 / (ms * 1e-3) / 1e9
    bnd = bound(0.0, 16.0 * re.numel())
    print(f"relayout kernel n={n} sigma={sigma.tolist()}: bit-exact; kernel "
          f"{ms:.4f} ms ({gbs:.0f} GB/s), plain {plain_ms:.4f} ms, "
          f"permute-copy {library_ms:.4f} ms, bound {bnd[0]:.4f} ms")
    return record("relayout", RELAYOUT_SRC, RELAYOUT_TPU, 0.0, ms, plain_ms,
                  bnd, library_ms)


def folded_blocks(PF, rng, logt, sigma):
    """Folded-relayout blocks (scal mode 5) whose first step is a mat, a
    tswap or a perm; the gather-first ones hold gathers only, so the kernel
    must equal the plain version bit for bit."""
    u = random_unitary(rng, 128)
    kind_perm = logt + 1
    return [
        ("mat-first", PF._Block(kinds=[0, 3], midx=[0, 0], relayout_pro=sigma,
                                mats=[(u, tuple(range(7)), None)])),
        ("tswap-first", PF._Block(kinds=[logt, kind_perm], midx=[0, 2],
                                  relayout_pro=sigma)),
        ("perm-first", PF._Block(kinds=[kind_perm, 1], midx=[5, 0],
                                 relayout_pro=sigma)),
        ("tswap-only", PF._Block(kinds=[logt], midx=[0],
                                 relayout_pro=sigma)),
    ]


def device_tables(torch, PF, blocks, cap):
    groups = PF.materialize_entries(blocks, PF.CAP_STEPS, cap, np.float32)
    assert len(groups) == 1, "synthetic blocks must share one table group"
    (_, _, scal, *tabs) = groups[0]
    return (scal, *PF.expand_tables(
        *(torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in tabs)))


def check_folded_block(torch, rng):
    """The folded-relayout input (mode 5) at n=24 geometry, both rungs."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, run_block_plain)
    from gpu_quantum_simulator_tpu_torch.kernels.relayout import run_relayout

    n = FOLD_WIDTH
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    logt = int(np.log2(PF.tile_rows(n)))
    tr = PF.relayout_rows(n)
    m = int(np.log2(R2 // tr))
    sigma = rng.permutation(m).astype(np.int32)
    named = folded_blocks(PF, rng, logt, sigma)
    scal, a_tab, b_tab, mono_src = device_tables(
        torch, PF, [b for _, b in named], 2)
    soff = 4 + 2 * PF.CAP_STEPS
    re = torch.randn(R2, 256, device="cuda")
    im = torch.randn(R2, 256, device="cuda")
    err = 0.0
    for i, (name, _) in enumerate(named):
        assert scal[i][1] == 5 and list(scal[i][soff : soff + m]) == list(sigma)
        args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
        rungs = ("highest", "high") if name == "mat-first" else ("highest",)
        for rung in rungs:
            kw = dict(sigma=sigma, tr=tr, precision=rung)
            # a block's later launches may write into its input pair
            got = run_block(scal[i], re.clone(), im.clone(), *args, **kw)
            want = run_block_plain(scal[i], re, im, *args, **kw)
            torch.cuda.synchronize()
            e = max_diff(got, want)
            exact = name != "mat-first"
            print(f"folded block n={n} sigma={sigma.tolist()} {name} "
                  f"{rung}: max|diff| {e:.3e}")
            if exact and e != 0.0:
                raise AssertionError(f"folded {name}: not bit-exact ({e})")
            if not e <= BLOCK_TOL:
                raise AssertionError(f"folded {name} {rung}: {e} > {BLOCK_TOL}")
            err = max(err, e)
    # one folded launch (a tswap) against its plain version, and against
    # the unfolded pair it replaces (relayout kernel + tswap launch)
    i = len(named) - 1
    args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
    kw = dict(sigma=sigma, tr=tr)
    scratch = (torch.empty_like(re), torch.empty_like(im))
    spare = (torch.empty_like(re), torch.empty_like(im))
    plain_row = scal[i].copy()
    plain_row[1] = 0
    ms = device_ms(torch, lambda: run_block(scal[i], re, im, *args,
                                          scratch=scratch, **kw))
    plain_ms = device_ms(torch, lambda: run_block_plain(scal[i], re, im,
                                                        *args, **kw))
    pair_ms = device_ms(torch, lambda: run_block(
        plain_row, *run_relayout(sigma, re, im, tr, out=spare), *args,
        scratch=scratch))
    # the launch is one bit permutation: sigma over the row-block bits,
    # then flat bits 7 and 7 + logt exchanged (the tswap)
    rel = relayout_bits(n, tr, sigma)
    swap = list(range(n))
    swap[7], swap[7 + logt] = 7 + logt, 7
    src = [rel[swap[b]] for b in range(n)]
    pair = torch.stack([re.reshape(-1), im.reshape(-1)])
    got = run_block(scal[i], re, im, *args, scratch=scratch, **kw)
    lib = bit_permute(pair, src)
    if not (torch.equal(lib[0], got[0].reshape(-1))
            and torch.equal(lib[1], got[1].reshape(-1))):
        raise AssertionError("folded tswap: the permute-copy differs")
    library_ms = device_ms(torch, lambda: bit_permute(pair, src))
    bnd = bound(0.0, 16.0 * re.numel())
    print(f"folded tswap launch n={n}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, unfolded relayout + tswap kernels "
          f"{pair_ms:.4f} ms, permute-copy {library_ms:.4f} ms, bound "
          f"{bnd[0]:.4f} ms")
    return record("stream_block_folded_input", BLOCK_SRC, STREAM_TPU, err, ms,
                  plain_ms, bnd, library_ms)


def check_high_mat(torch, rng):
    """The "high" mat step (bf16 tensor cores) at n=24 and one at n=28."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, run_block_plain, split_tables)

    blk = PF._Block(kinds=[0], midx=[0],
                    mats=[(random_unitary(rng, 128), tuple(range(7)), None)])
    scal, a_tab, b_tab, mono_src = device_tables(torch, PF, [blk], 2)
    w16 = split_tables(a_tab, b_tab)
    rec = None
    for n, reps in HIGH_STEPS:
        R2 = 1 << (n - PF.LOCAL_QUBITS)
        logt = int(np.log2(PF.tile_rows(n)))
        re = torch.randn(R2, 256, device="cuda")
        im = torch.randn(R2, 256, device="cuda")
        args = (a_tab[0], b_tab[0], mono_src[0], logt, PF.CAP_STEPS)
        scratch = (torch.empty_like(re), torch.empty_like(im))
        got = run_block(scal[0], re.clone(), im.clone(), *args,
                        scratch=scratch, precision="high", w16=w16[0])
        want = run_block_plain(scal[0], re, im, *args, precision="high")
        torch.cuda.synchronize()
        e = max_diff(got, want)
        fp32 = run_block(scal[0], re.clone(), im.clone(), *args,
                         precision="highest")
        torch.cuda.synchronize()
        e32 = max_diff(got, fp32)
        if not e <= BLOCK_TOL:
            raise AssertionError(f"high mat step n={n}: {e} > {BLOCK_TOL}")
        # the table is unitary: each output's norm should equal the input's
        drift = {k: norm2(v) / norm2((re, im)) - 1.0
                 for k, v in (("kernel", got), ("plain", want),
                              ("fp32 kernel", fp32))}
        print(f"high mat step n={n}: |out|^2/|in|^2 - 1: "
              + ", ".join(f"{k} {v:.3e}" for k, v in drift.items()))
        del fp32, want
        ms = device_ms(torch, lambda: run_block(
            scal[0], re, im, *args, scratch=scratch, precision="high",
            w16=w16[0]), reps=reps)
        ms32 = device_ms(torch, lambda: run_block(
            scal[0], re, im, *args, scratch=scratch), reps=reps)
        plain_ms = device_ms(torch, lambda: run_block_plain(
            scal[0], re, im, *args, precision="high"), reps=reps)
        flop = 6.0 * R2 * 256 * 256      # three real products (Karatsuba)
        # 9 bf16 products (3 real x 3 passes), the state read and written
        # once, four bf16 tables
        bnd = bound(3 * flop, 16.0 * R2 * 256 + 4 * 256 * 256 * 2,
                    BF16_FLOPS)
        print(f"high mat step n={n}: kernel {ms:.4f} ms ({3 * flop / ms / 1e9:.1f}"
              f" bf16 TFLOP/s), plain {plain_ms:.4f} ms, fp32 kernel "
              f"{ms32:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); max|diff| "
              f"vs plain {e:.3e}, vs fp32 step {e32:.3e}")
        if rec is None:
            # no PyTorch call computes the 3-pass bf16 product
            rec = record("mat_step_high", HIGH_SRC, STREAM_TPU, e, ms,
                         plain_ms, bnd, None)
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        del re, im, scratch, got
        torch.cuda.empty_cache()
    return rec


def check_high_drift(torch):
    """200 chained "high" mat steps at n=24 on a normalised random state,
    the tables eight random 256 x 256 unitaries taken in turn (a block
    entry's eight slots): the norm's drift after every step, kernel and
    plain version each on its own chain, for every seed of DRIFT_SEEDS (a
    state and tables each).  A unitary keeps the norm; what remains is the
    rung's rounding, and in the kernel the tensor core's truncating adds
    (mma_high.cuh).  Its draws have seeds of their own, so the phases after
    it draw as they did without it."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, run_block_plain, split_tables)

    n, cap = DRIFT_WIDTH, PF.CAP_STEPS
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    logt = int(np.log2(PF.tile_rows(n)))
    mono = torch.zeros(DRIFT_SLOTS, 256, dtype=torch.int32, device="cuda")

    def row(j):           # one mat step on slot j
        return [1, 0, 0, 0] + [0] * cap + [j] + [0] * (cap - 1)

    last = {}
    for seed in DRIFT_SEEDS:
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        mats = [random_unitary(rng, 256) for _ in range(DRIFT_SLOTS)]
        a_tab = torch.tensor(np.stack([m.real.T for m in mats]),
                             dtype=torch.float32, device="cuda").contiguous()
        b_tab = torch.tensor(np.stack([m.imag.T for m in mats]),
                             dtype=torch.float32, device="cuda").contiguous()
        w16 = split_tables(a_tab, b_tab)
        re, im = (torch.randn(R2, 256, device="cuda", generator=gen)
                  for _ in range(2))
        scale = norm2((re, im)) ** -0.5
        start = (re * scale, im * scale)
        n0 = norm2(start)
        kern = (start[0].clone(), start[1].clone())
        spare = (torch.empty_like(re), torch.empty_like(im))
        plain = start
        drift = {"kernel": [], "plain": []}
        for step in range(DRIFT_STEPS):
            j = step % DRIFT_SLOTS
            out = run_block(row(j), *kern, a_tab, b_tab, mono, logt, cap,
                            scratch=spare, precision="high", w16=w16)
            spare, kern = kern, out
            plain = run_block_plain(row(j), *plain, a_tab, b_tab, mono, logt,
                                    cap, precision="high")
            drift["kernel"].append(norm2(kern) / n0 - 1.0)
            drift["plain"].append(norm2(plain) / n0 - 1.0)
        for k, v in drift.items():
            print(f"high drift n={n} seed {seed} {k}: |out|^2/|in|^2 - 1 "
                  f"after steps 1..{DRIFT_STEPS}: "
                  + json.dumps([float(f"{x:.3g}") for x in v]))
        last[seed] = (drift["kernel"][-1], drift["plain"][-1])
        k, p = last[seed]
        print(f"high drift n={n} seed {seed}: |1 - norm| after {DRIFT_STEPS} "
              f"steps kernel {abs(k):.4e}, plain {abs(p):.4e} (ratio "
              f"{abs(k / p):.3f}); the kernel's beyond the plain's "
              f"{k - p:.4e}; the state's norm at the start {n0:.10f}")
        del kern, spare, plain, start, re, im, out, a_tab, b_tab, w16
        torch.cuda.empty_cache()
    worst_k = max(abs(k) for k, _ in last.values())
    worst_p = max(abs(p) for _, p in last.values())
    excess = max(abs(k - p) for k, p in last.values())
    print(f"high drift n={n} over seeds {list(DRIFT_SEEDS)}: largest |1 - "
          f"norm| after {DRIFT_STEPS} steps kernel {worst_k:.4e}, plain "
          f"{worst_p:.4e} (ratio {worst_k / worst_p:.3f}, bar {DRIFT_RATIO}); "
          f"largest |kernel - plain| {excess:.4e} (bar {DRIFT_EXCESS}); "
          f"per-seed ratios " + json.dumps(
              {s: round(abs(k / p), 3) for s, (k, p) in last.items()}))
    if not (worst_k <= DRIFT_RATIO * worst_p and excess <= DRIFT_EXCESS):
        raise AssertionError(f"high drift n={n}: kernel {worst_k} against "
                             f"{DRIFT_RATIO} x plain {worst_p}; beyond the "
                             f"plain {excess} against {DRIFT_EXCESS}")


def check_wide_chain(torch, rng):
    """The lane-layout chain kernel at n=24 on a normalized state: P = 1
    and 8 products at both rungs (kernel 7) and one product as
    ``apply_block128`` (kernel 9).  Library call: P complex64
    torch.matmul (none for the 3-pass bf16 rung)."""
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW

    n = WIDE_WIDTH
    R = 1 << (n - 7)
    re = torch.randn(R, 128, device="cuda")
    im = torch.randn(R, 128, device="cuda")
    scale = float(torch.sqrt((re.double() ** 2).sum() + (im.double() ** 2).sum()))
    re /= scale
    im /= scale
    x = torch.complex(re, im)
    recs = {}
    for P in (1, 8):
        us = [random_unitary(rng, 128) for _ in range(P)]
        tabs = torch.from_numpy(np.stack([np.stack([u.real, u.imag])
                                          for u in us]).astype(np.float32)).cuda()
        mt = torch.from_numpy(np.stack([u.T for u in us]).astype(np.complex64)).cuda()

        def library(mt=mt):
            y = x
            for j in range(mt.shape[0]):
                y = torch.matmul(y, mt[j])
            return y

        lib = library()
        library_ms = device_ms(torch, library, reps=10)
        for prec in ("highest", "high"):
            w16 = KW.split_wide_tables(tabs) if prec == "high" else None
            got = KW.kh0_chain(re, im, tabs, prec, w16=w16)
            want = KW.kh0_chain_plain(re, im, tabs, prec)
            inplace = (re.clone(), im.clone())
            KW.kh0_chain(*inplace, tabs, prec, out=inplace, w16=w16)
            torch.cuda.synchronize()
            e = max_diff(got, want)
            e_lib = max_diff(got, (lib.real, lib.imag))
            if not e <= CHAIN_TOL:
                raise AssertionError(f"chain P={P} {prec}: {e} > {CHAIN_TOL}")
            if not (torch.equal(inplace[0], got[0])
                    and torch.equal(inplace[1], got[1])):
                raise AssertionError(f"chain P={P} {prec}: in place differs")
            out = (torch.empty_like(re), torch.empty_like(im))
            ms = device_ms(torch, lambda: KW.kh0_chain(
                re, im, tabs, prec, out=out, w16=w16), reps=10)
            plain_ms = device_ms(torch, lambda: KW.kh0_chain_plain(
                re, im, tabs, prec), reps=5)
            flop = 6.0 * R * 128 * 128 * P      # three real products each
            nbytes = 16.0 * R * 128
            if prec == "high":
                bnd = bound(3 * flop, nbytes + P * 4 * 128 * 128 * 2,
                            BF16_FLOPS)
            else:
                bnd = bound(flop, nbytes + P * 2 * 128 * 128 * 4)
            print(f"chain kernel n={n} P={P} {prec}: max|diff| vs plain "
                  f"{e:.3e}, vs complex64 matmul {e_lib:.3e}; in place "
                  f"bit-exact; kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} "
                  f"TFLOP/s, Karatsuba count), plain {plain_ms:.4f} ms, "
                  f"complex64 torch.matmul x{P} {library_ms:.4f} ms, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})")
            if P == 8:
                name = "wide_chain_kh0" + ("_high" if prec == "high" else "")
                recs[prec] = record(name, WIDE_SRC, KH0_TPU, e, ms, plain_ms,
                                    bnd, library_ms if prec == "highest"
                                    else None)
            del got, want, inplace, out
        if P == 1:
            got = KW.apply_block128(re, im, tabs[0, 0], tabs[0, 1])
            want = KW.apply_block128_plain(re, im, tabs[0, 0], tabs[0, 1])
            torch.cuda.synchronize()
            e = max_diff(got, want)
            if not e <= CHAIN_TOL:
                raise AssertionError(f"apply_block128: {e} > {CHAIN_TOL}")
            out = (torch.empty_like(re), torch.empty_like(im))
            ms = device_ms(torch, lambda: KW.apply_block128(
                re, im, tabs[0, 0], tabs[0, 1], out=out), reps=10)
            plain_ms = device_ms(torch, lambda: KW.apply_block128_plain(
                re, im, tabs[0, 0], tabs[0, 1]), reps=10)
            bnd = bound(6.0 * R * 128 * 128,
                        16.0 * R * 128 + 2 * 128 * 128 * 4)
            print(f"apply_block128 n={n}: max|diff| vs plain {e:.3e}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, complex64 "
                  f"torch.matmul {library_ms:.4f} ms, bound {bnd[0]:.4f} ms "
                  f"({bnd[1]})")
            recs["block128"] = record("apply_block128", WIDE_SRC,
                                      BLOCK128_TPU, e, ms, plain_ms, bnd,
                                      library_ms)
            del got, want, out
    return recs["highest"], recs["high"], recs["block128"]


def vmem_chunk_ops(T, n):
    """The vmem fusion of the benchmark circuit, as the Simulator plans it
    (relabeled, blocks of <= 7 low plus 2 high qubits)."""
    from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline
    from gpu_quantum_simulator_tpu_torch.passes.permute import plan_permutation

    c = T.models.grover_like(n, 2445, 318)
    return _fuse_pipeline(c.relabeled(plan_permutation(c)), 7, max_high=2)


def one_op_tables(KV, tab, j):
    """Op j of a chunk's tables as a one-op chunk (views of its tables)."""
    row_bits, off, D = tab.steps[j]
    desc = tab.desc[j : j + 1].clone()
    desc[0, 3] = 0
    return KV.VmemTables(tab.num_qubits, tab.mats[off : off + 2 * D * D],
                         desc, [(row_bits, 0, D)], tab.max_tiles)


def check_vmem_kernel(torch, T):
    """Kernel 8 at n=18 on a normalized state: the first 96-op chunk of the
    benchmark circuit's vmem fusion, and that chunk's first D=512 op alone
    (its library call: one complex64 torch.matmul on the already-shuffled
    state).  Returns (chunk record, one-op record)."""
    import dataclasses

    from gpu_quantum_simulator_tpu_torch.engine import vmem as V
    from gpu_quantum_simulator_tpu_torch.engine.wide import row_shuffles
    from gpu_quantum_simulator_tpu_torch.kernels import vmem as KV

    n = 18
    R = 1 << (n - 7)
    ops = vmem_chunk_ops(T, n)[:V.CHUNK_OPS]
    tab, = V.build_vmem_program(ops, n, device="cuda").chunks
    g = torch.Generator(device="cuda").manual_seed(n)
    re = torch.randn(R, 128, device="cuda", generator=g)
    im = torch.randn(R, 128, device="cuda", generator=g)
    scale = float(torch.sqrt((re.double() ** 2).sum() + (im.double() ** 2).sum()))
    re /= scale
    im /= scale
    got = KV.vmem_chunk(re.clone(), im.clone(), tab)
    want = KV.vmem_chunk_plain(re, im, tab)
    # the same chunk with op 0's two imaginary-table products dropped
    _, off, D = tab.steps[0]
    mats = tab.mats.clone()
    mats[off + D * D : off + 2 * D * D] = 0
    dropped = KV.vmem_chunk_plain(re, im, dataclasses.replace(tab, mats=mats))
    torch.cuda.synchronize()
    e = max_diff(got, want)
    e_drop = max_diff(got, dropped)
    grid = KV.vmem_chunk.last_grid
    if not e <= VMEM_TOL:
        raise AssertionError(f"vmem chunk n={n}: {e} > {VMEM_TOL}")
    if not e_drop > VMEM_TOL:
        raise AssertionError(f"vmem chunk: a dropped product passes ({e_drop})")
    del got, want, dropped, mats
    scratch = (torch.empty_like(re), torch.empty_like(im))
    ms = device_ms(torch, lambda: KV.vmem_chunk(re, im, tab, scratch=scratch),
                   reps=10)
    plain_ms = device_ms(torch, lambda: KV.vmem_chunk_plain(re, im, tab),
                         reps=3)
    by_d = [d for _, _, d in tab.steps]
    flop = sum(6.0 * (1 << n) * d for d in by_d)   # Karatsuba, per op
    nbytes = 16.0 * (1 << n) + sum(8.0 * d * d for d in by_d)
    bnd = bound(flop, nbytes)
    print(f"vmem chunk kernel n={n}: {len(by_d)} ops (D=512 {by_d.count(512)}"
          f", D=256 {by_d.count(256)}), grid {grid}; max|diff| vs plain "
          f"{e:.3e}, with op 0's imaginary products dropped {e_drop:.3e}; "
          f"kernel {ms:.4f} ms ({ms / len(by_d) * 1e3:.2f} us per op, "
          f"{flop / ms / 1e9:.1f} TFLOP/s as Karatsuba), plain "
          f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    chunk = record("vmem_chunk", VMEM_SRC, VMEM_TPU, e, ms, plain_ms, bnd,
                   None)

    # the same ops as one-op launches: a kernel boundary between ops where
    # the chunk has a grid barrier
    singles = [one_op_tables(KV, tab, j) for j in range(len(by_d))]

    def one_by_one():
        cur, spare = (re, im), scratch
        for one in singles:
            cur, spare = KV.vmem_chunk(*cur, one, scratch=spare), cur

    singles_ms = device_ms(torch, one_by_one, reps=3)
    print(f"vmem chunk n={n} as {len(by_d)} one-op launches: "
          f"{singles_ms:.4f} ms against {ms:.4f} ms in one launch; a grid "
          f"barrier costs {(ms - singles_ms) / (len(by_d) - 1) * 1e3:+.2f} "
          f"us per op beyond a kernel boundary")

    # one D=512 op: the kernel on a one-op chunk, its plain version, and
    # the complex64 product on the state already shuffled for it
    one = singles[by_d.index(512)]
    row_bits, off, D = one.steps[0]
    got = KV.vmem_chunk(re, im, one, scratch=scratch)
    want = KV.vmem_chunk_plain(re, im, one)
    fwd, bwd = row_shuffles(row_bits, R)
    x = torch.complex(fwd(re), fwd(im))
    mt = torch.complex(one.mats[off : off + D * D].view(D, D),
                       one.mats[off + D * D : off + 2 * D * D].view(D, D))
    lib = torch.matmul(x, mt)
    torch.cuda.synchronize()
    e1 = max_diff(got, want)
    e_lib = max_diff(got, (bwd(lib.real), bwd(lib.imag)))
    if not (e1 <= VMEM_TOL and e_lib <= VMEM_TOL):
        raise AssertionError(f"vmem one op: {e1}, library {e_lib}")
    ms1 = device_ms(torch, lambda: KV.vmem_chunk(re, im, one,
                                                 scratch=scratch))
    plain1 = device_ms(torch, lambda: KV.vmem_chunk_plain(re, im, one))
    library_ms = device_ms(torch, lambda: torch.matmul(x, mt))
    bnd1 = bound(6.0 * (1 << n) * D, 16.0 * (1 << n) + 8.0 * D * D)
    print(f"vmem one op n={n} D={D} row bits {row_bits}: max|diff| vs plain "
          f"{e1:.3e}, vs complex64 matmul {e_lib:.3e}; kernel {ms1:.4f} ms "
          f"(the chunk's per-op share {ms / len(by_d):.4f} ms), plain "
          f"{plain1:.4f} ms, complex64 torch.matmul on the shuffled state "
          f"{library_ms:.4f} ms, bound {bnd1[0]:.4f} ms ({bnd1[1]})")
    op = record("vmem_chunk_one_op", VMEM_SRC, VMEM_TPU, e1, ms1, plain1,
                bnd1, library_ms)
    return chunk, op


def launch_counts():
    from gpu_quantum_simulator_tpu_torch.kernels import (
        block, relayout, split, vmem, wide)

    return {**block.run_block.launches,
            "relayout": relayout.run_relayout.launches,
            "kh0": wide.kh0_chain.launches["highest"],
            "kh0_high": wide.kh0_chain.launches["high"],
            "block128": wide.apply_block128.launches,
            "vmem": vmem.vmem_chunk.launches,
            **{f"split_{k}": v
               for k, v in split.run_split_block.launches.items()},
            "xswap": split.run_xswap.launches,
            "relayout_inplace": relayout.run_relayout_inplace.launches}


def reset_counts():
    from gpu_quantum_simulator_tpu_torch.kernels import (
        block, relayout, split, vmem, wide)

    block.reset_launches()
    wide.reset_launches()
    vmem.reset_launches()
    split.reset_launches()
    relayout.run_relayout.launches = 0
    relayout.run_relayout_inplace.launches = 0


def drive(torch, PF, sim, c, runs):
    """One warm-up and ``runs`` timed run_detailed on a fresh program, the
    launch counts set to 0 just before and read just after.  Returns the
    last result, the timed seconds, the counts and the program's scal rows
    by mode."""
    PF._RUN_CACHE.clear()
    PF._PROGRAM_CACHE.clear()
    torch.cuda.empty_cache()
    reset_counts()
    warm = sim.run_detailed(c)
    secs = [warm.seconds]
    res = warm
    for _ in range(runs):
        res = sim.run_detailed(c)
        secs.append(res.seconds)
    counts = launch_counts()
    (prog,) = PF._RUN_CACHE.values()
    return res, secs, counts, dict(prog.mode_rows)


def report(n, res, secs, counts, extra):
    print(f"main path n={n}: {res.num_fused_ops} steps from {res.num_gates} "
          f"gates; warm-up {secs[0]:.4f} s; run_detailed median "
          f"{np.median(secs[1:]):.4f} s (min {min(secs[1:]):.4f}, runs "
          f"{[round(x, 4) for x in secs[1:]]}); {extra}; launches {counts}")
    if not (res.state.shape == (1 << n,) and np.isfinite(res.state).all()):
        raise AssertionError(f"n={n}: state is not finite of shape 2^n")


def check_counts(n, counts, modes, runs, high):
    """Launch counts of ``runs`` runs of one program against its plan;
    ``high``: the run was at the "high" rung."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF

    block = counts["mat"] + counts["mat_high"] + counts["gather"] + counts["folded"]
    fold = PF.resolve_stream_relayout(n)
    if block <= 0:
        raise AssertionError(f"n={n}: the block kernel never launched")
    if counts["relayout"] != runs * modes.get(3, 0):
        raise AssertionError(
            f"n={n}: {counts['relayout']} relayout launches for "
            f"{modes.get(3, 0)} standalone relayouts x {runs} runs")
    if fold and not counts["folded"] > 0:
        raise AssertionError(f"n={n}: no folded-relayout launch")
    if counts["folded"] != runs * modes.get(5, 0):
        raise AssertionError(f"n={n}: folded launches {counts['folded']} "
                             f"for {modes.get(5, 0)} mode-5 rows x {runs}")
    if high != (counts["mat_high"] > 0):
        raise AssertionError(f"n={n}: 'high' mat launches "
                             f"{counts['mat_high']} at high={high}")


def run_prefetch_path(torch, T, refs, add):
    """The prefetch strategy; returns the n=24 "highest" state."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF

    prefetch = T.Simulator(T.SimulatorConfig(strategy="prefetch"),
                           device="cuda")
    auto = T.Simulator(T.SimulatorConfig(strategy="auto"), device="cuda")
    for n in REF_WIDTHS:
        sim = prefetch if n <= 22 else auto
        c = T.models.grover_like(n, 2445, 318)
        res, secs, counts, modes = drive(torch, PF, sim, c, TIMED_RUNS)
        add(counts)
        err = float(np.max(np.abs(res.state - refs[n])))
        norm = float(np.linalg.norm(res.state))
        report(n, res, secs, counts, f"max|amp - f64| {err:.3e}; norm "
               f"{norm:.8f}; scal rows by mode {modes}")
        if not err <= AMP_TOL:
            raise AssertionError(f"n={n}: max|amp diff| {err} > {AMP_TOL}")
        if not abs(norm - 1.0) <= NORM_TOL:
            raise AssertionError(f"n={n}: norm {norm}")
        check_counts(n, counts, modes, TIMED_RUNS + 1, False)
        del res

    # n=24: "auto" resolves to the "high" rung; held to the port's own
    # "highest" run of the same circuit
    n = HIGH_WIDTH
    c = T.models.grover_like(n, 2445, 318)
    res, secs, counts, modes = drive(torch, PF, auto, c, TIMED_RUNS)
    add(counts)
    highest = T.Simulator(T.SimulatorConfig(strategy="auto",
                                            precision="highest"),
                          device="cuda")
    ref, ref_secs, ref_counts, ref_modes = drive(torch, PF, highest, c, 0)
    add(ref_counts)
    err = float(np.max(np.abs(res.state - ref.state)))
    norm = float(np.linalg.norm(res.state))
    report(n, res, secs, counts, f"'high' vs 'highest' max|diff| {err:.3e} "
           f"('highest' run {ref_secs[0]:.4f} s, launches {ref_counts}); "
           f"norm {norm:.8f}; scal rows by mode {modes}")
    if not 0.0 < err <= HIGH_TOL:
        raise AssertionError(f"n={n}: 'high' vs 'highest' {err}")
    if not abs(norm - 1.0) <= NORM_TOL:
        raise AssertionError(f"n={n}: norm {norm}")
    check_counts(n, counts, modes, TIMED_RUNS + 1, True)
    check_counts(n, ref_counts, ref_modes, 1, False)
    highest24 = ref.state
    del res, ref

    # n=28: timed at "high"; its mirror circuit at "highest" must return
    # to |0...0> (a check with no reference at a width the host cannot
    # simulate in time)
    n = MIRROR_WIDTH
    c = T.models.grover_like(n, 2445, 318)
    res, secs, counts, modes = drive(torch, PF, auto, c, 3)
    add(counts)
    norm = float(np.linalg.norm(res.state))
    report(n, res, secs, counts, f"norm {norm:.8f}; scal rows by mode "
           f"{modes}")
    del res
    mirror = c.compose(c.inverse())     # compose appends to c in place
    back, back_secs, back_counts, back_modes = drive(torch, PF, highest,
                                                     mirror, 0)
    add(back_counts)
    amp0 = complex(back.state[0])
    print(f"mirror n={n}: {back.num_gates} gates at 'highest', "
          f"{back.num_fused_ops} steps, {back_secs[0]:.4f} s; <0|psi> "
          f"{amp0:.8f}; launches {back_counts}; scal rows by mode "
          f"{back_modes}")
    del back
    if not abs(norm - 1.0) <= NORM_TOL:
        raise AssertionError(f"n={n}: norm {norm}")
    if not abs(amp0 - 1.0) <= MIRROR_TOL:
        raise AssertionError(f"n={n}: mirror |0> amplitude {amp0}")
    check_counts(n, counts, modes, 4, True)
    check_counts(n, back_counts, back_modes, 1, False)
    PF._RUN_CACHE.clear()
    PF._PROGRAM_CACHE.clear()
    return highest24


def drive_engine(torch, sim, c, runs, cache):
    """drive() for the mxu and pallas engines: one warm-up and ``runs``
    timed run_detailed on a fresh plan (``cache``: the engine's plan cache,
    holding just this circuit's plan afterwards), counts set to 0 just
    before and read just after."""
    cache.clear()
    torch.cuda.empty_cache()
    reset_counts()
    res = sim.run_detailed(c)
    secs = [res.seconds]
    for _ in range(runs):
        res = sim.run_detailed(c)
        secs.append(res.seconds)
    return res, secs, launch_counts()


def check_only(n, counts, runs, **want):
    """Each counted kind launched ``want[kind]`` times per run, every other
    kind never."""
    for kind, got in counts.items():
        if got != runs * want.get(kind, 0):
            raise AssertionError(f"n={n}: {got} {kind} launches in {runs} "
                                 f"runs, plan {want}")


def low_only(T, n, gates, seed):
    """tests/test_precision_auto.py:79-91 at ``gates`` gates: qubits 0..6
    only, so every fused block is kh = 0."""
    rng = np.random.default_rng(seed)
    c = T.Circuit(n)
    for _ in range(gates):
        kind = rng.integers(3)
        q = int(rng.integers(7))
        if kind == 0:
            c.h(q)
        elif kind == 1:
            c.rz(float(rng.uniform(-3, 3)), q)
        else:
            r = int(rng.integers(7))
            if r != q:
                c.cx(q, r)
    return c


def run_mxu_path(torch, T, refs, highest24, add):
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S

    def mxu(**kw):
        return T.Simulator(T.SimulatorConfig(strategy="mxu", **kw),
                           device="cuda")

    def plan():
        (ops, prog), = S._MXU_PLAN_CACHE.values()
        return prog, [st[2] for seg in prog.segments for st in seg.steps
                      if st[0] == "kh0"]

    kh0 = {"highest": "kh0", "high": "kh0_high"}
    runs = ENGINE_RUNS + 1
    for n in ENGINE_REF_WIDTHS:
        c = T.models.grover_like(n, 2445, 318)
        res, secs, counts = drive_engine(torch, mxu(), c, ENGINE_RUNS,
                                         S._MXU_PLAN_CACHE)
        add(counts)
        prog, ps = plan()
        err = float(np.max(np.abs(res.state - refs[n])))
        report(n, res, secs, counts, f"mxu; max|amp - f64| {err:.3e}; kh0 "
               f"runs {ps}")
        if not err <= AMP_TOL:
            raise AssertionError(f"mxu n={n}: max|amp diff| {err}")
        check_only(n, counts, runs, kh0=prog.num_kh0_runs)
        if n == ENGINE_REF_WIDTHS[0]:
            # the default config: Simulator(device="cuda") runs mxu
            dflt = T.Simulator(device="cuda").run_detailed(c)
            e = float(np.max(np.abs(dflt.state - refs[n])))
            print(f"Simulator(device='cuda') n={n}: strategy "
                  f"{dflt.strategy}, {dflt.seconds:.4f} s, max|amp - f64| "
                  f"{e:.3e}")
            if dflt.strategy != "mxu" or not e <= AMP_TOL:
                raise AssertionError("the default config did not run mxu")
        del res

    # n=24: "auto" -> "high", against its own "highest" run, which is held
    # to the prefetch engine's "highest" state
    n = HIGH_WIDTH
    c = T.models.grover_like(n, 2445, 318)
    res, secs, counts = drive_engine(torch, mxu(), c, ENGINE_RUNS,
                                     S._MXU_PLAN_CACHE)
    add(counts)
    prog, ps = plan()
    check_only(n, counts, runs, kh0_high=prog.num_kh0_runs)
    ref, ref_secs, ref_counts = drive_engine(
        torch, mxu(precision="highest"), c, 0, S._MXU_PLAN_CACHE)
    add(ref_counts)
    err = float(np.max(np.abs(res.state - ref.state)))
    e_pf = float(np.max(np.abs(ref.state - highest24)))
    norm = float(np.linalg.norm(res.state))
    report(n, res, secs, counts, f"mxu 'high'; vs its 'highest' run "
           f"{err:.3e} ('highest' run {ref_secs[0]:.4f} s); 'highest' vs "
           f"prefetch 'highest' {e_pf:.3e}; norm {norm:.8f}; kh0 runs {ps}")
    if not 0.0 < err <= HIGH_TOL:
        raise AssertionError(f"mxu n={n}: 'high' vs 'highest' {err}")
    if not e_pf <= AMP_TOL:
        raise AssertionError(f"mxu n={n}: 'highest' vs prefetch {e_pf}")
    if not abs(norm - 1.0) <= NORM_TOL:
        raise AssertionError(f"mxu n={n}: norm {norm}")
    del res, ref

    # the low-only circuit: max_fused_qubits=3 gives chains of P = 8,
    # held to the same circuit at max_fused_qubits=7 (one P = 1 chain)
    n, gates, seed = LOW_ONLY
    c = low_only(T, n, gates, seed)
    for prec in ("highest", "high"):
        states = {}
        for k in (3, 7):
            res, secs, counts = drive_engine(
                torch, mxu(precision=prec, max_fused_qubits=k), c, 1,
                S._MXU_PLAN_CACHE)
            add(counts)
            prog, ps = plan()
            report(n, res, secs, counts, f"mxu low-only {prec} "
                   f"max_fused_qubits={k}: kh0 runs {ps}")
            check_only(n, counts, 2, **{kh0[prec]: prog.num_kh0_runs})
            if ps != ([8] * 9 if k == 3 else [1]):
                raise AssertionError(f"low-only k={k}: kh0 runs {ps}")
            states[k] = res.state
        err = float(np.max(np.abs(states[3] - states[7])))
        peak = float(np.max(np.abs(states[7])))
        tol = AMP_TOL if prec == "highest" else HIGH_TOL * max(
            1.0, peak / HIGH_BAR_PEAK)
        print(f"mxu low-only n={n} {prec}: nine P=8 chains vs one P=1 chain "
              f"max|diff| {err:.3e} (bar {tol:.3e}, peak |amp| {peak:.4f})")
        if not err <= tol:
            raise AssertionError(f"low-only {prec}: {err} > {tol}")
    S._MXU_PLAN_CACHE.clear()


def run_pallas_path(torch, T, refs, add):
    from gpu_quantum_simulator_tpu_torch.engine import pallas_engine as PE

    sim = T.Simulator(T.SimulatorConfig(strategy="pallas"), device="cuda")
    for n in ENGINE_REF_WIDTHS:
        c = T.models.grover_like(n, 2445, 318)
        res, secs, counts = drive_engine(torch, sim, c, ENGINE_RUNS,
                                         PE._CACHE)
        add(counts)
        (prog, _, items), = PE._CACHE.values()
        err = float(np.max(np.abs(res.state - refs[n])))
        report(n, res, secs, counts, f"pallas; {prog.num_mats} mat items, "
               f"{prog.num_swaps} swaps; max|amp - f64| {err:.3e}")
        if not err <= AMP_TOL:
            raise AssertionError(f"pallas n={n}: max|amp diff| {err}")
        check_only(n, counts, ENGINE_RUNS + 1, block128=prog.num_mats)
        del res
    PE._CACHE.clear()


def run_vmem_path(torch, T, refs, add):
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S
    from gpu_quantum_simulator_tpu_torch.engine import vmem as V

    sim = T.Simulator(T.SimulatorConfig(strategy="vmem"), device="cuda")
    for n in VMEM_WIDTHS:
        c = T.models.grover_like(n, 2445, 318)
        V._CACHE.clear()
        res, secs, counts = drive_engine(torch, sim, c, TIMED_RUNS,
                                         S._MXU_PLAN_CACHE)
        add(counts)
        (ops, prog), = S._MXU_PLAN_CACHE.values()
        err = float(np.max(np.abs(res.state - refs[n])))
        norm = float(np.linalg.norm(res.state))
        report(n, res, secs, counts, f"vmem; ops by D {prog.ops_by_D}, "
               f"{len(prog.chunks)} chunks; max|amp - f64| {err:.3e}; norm "
               f"{norm:.8f}")
        if not err <= AMP_TOL:
            raise AssertionError(f"vmem n={n}: max|amp diff| {err}")
        if not abs(norm - 1.0) <= NORM_TOL:
            raise AssertionError(f"vmem n={n}: norm {norm}")
        check_only(n, counts, TIMED_RUNS + 1, vmem=len(prog.chunks))
        del res, prog
        S._MXU_PLAN_CACHE.clear()
        V._CACHE.clear()
        torch.cuda.empty_cache()


def run_small_widths(torch, T, refs, add):
    """Every strategy at n = 2..8 (the megakernel arm, and the engines just
    above it at n = 8), and the megakernel strategy at n = 18, against the
    f64 reference; the megakernel arm launches no port kernel."""
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S
    from gpu_quantum_simulator_tpu_torch.ref.native import simulate_native

    worst = {}
    for n in SMALL_WIDTHS:
        c = T.models.grover_like(n, 200, 318)
        ref = simulate_native(c)
        for strategy in SMALL_STRATEGIES:
            reset_counts()
            res = T.Simulator(T.SimulatorConfig(strategy=strategy),
                              device="cuda").run_detailed(c)
            counts = launch_counts()
            add(counts)
            err = float(np.max(np.abs(res.state - ref)))
            worst[strategy] = max(worst.get(strategy, 0.0), err)
            if not (res.state.shape == (1 << n,) and err <= AMP_TOL):
                raise AssertionError(f"{strategy} n={n}: max|amp diff| {err}")
            arm = n <= 7 or strategy in ("megakernel", "prefetch")
            launched = {k: v for k, v in counts.items() if v}
            if arm and launched:
                raise AssertionError(f"{strategy} n={n}: the megakernel arm "
                                     f"launched {launched}")
            if strategy == "vmem" and n == 8:
                (_, prog), = [v for k, v in S._MXU_PLAN_CACHE.items()
                              if k[0] == "vmem" and k[2] == n]
                check_only(n, counts, 1, vmem=len(prog.chunks))
            print(f"small width {strategy} n={n}: {res.num_fused_ops} ops, "
                  f"{res.seconds:.4f} s, max|amp - f64| {err:.3e}, launches "
                  f"{launched or 'none'}")
    S._MXU_PLAN_CACHE.clear()
    print(f"small widths n={SMALL_WIDTHS.start}..{SMALL_WIDTHS.stop - 1}: "
          f"worst max|amp - f64| by strategy {worst}")

    n = ENGINE_REF_WIDTHS[0]
    sim = T.Simulator(T.SimulatorConfig(strategy="megakernel"), device="cuda")
    c = T.models.grover_like(n, 2445, 318)
    reset_counts()
    res = sim.run_detailed(c)
    secs = [res.seconds]
    res = sim.run_detailed(c)
    secs.append(res.seconds)
    counts = launch_counts()
    add(counts)
    err = float(np.max(np.abs(res.state - refs[n])))
    report(n, res, secs, counts, f"megakernel; max|amp - f64| {err:.3e}")
    if not err <= AMP_TOL:
        raise AssertionError(f"megakernel n={n}: max|amp diff| {err}")
    check_only(n, counts, 2)


# ------------------------------------------------- phase 5: the in-place engine
def random_halves(torch, n, scale=1.0 / 16):
    """Four (R2, 128) halves of entries ~ N(0, scale^2) (seeded by main)."""
    R2 = 1 << (n - 8)
    return tuple(torch.randn(R2, 128, device="cuda") * scale for _ in range(4))


def clone4(halves):
    return tuple(h.clone() for h in halves)


def joined(torch, halves):
    """The flat engine's (R2, 256) pair from four halves."""
    return (torch.cat(halves[:2], dim=1), torch.cat(halves[2:], dim=1))


def diff4(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def equal4(torch, got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def stack4(torch, halves):
    """The halves stacked as (re|im, half * row * lane): per component flat
    bits 0..6 are the lane, then the row bits, and the top bit is the half."""
    return torch.stack([torch.stack(halves[:2]),
                        torch.stack(halves[2:])]).reshape(2, -1)


def split_tables_for(torch, PF, blocks, cap, **kw):
    groups = PF.materialize_entries(blocks, PF.CAP_STEPS, cap, np.float32,
                                    single_class=True, **kw)
    assert len(groups) == 1, "synthetic blocks must share one table group"
    (_, _, scal, *tabs) = groups[0]
    return (scal, *PF.expand_tables(
        *(torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in tabs)))


def check_split_block(torch, rng):
    """Kernel 5(a) at n=24 on halves: a block of every step kind and one of
    index steps only, against the plain version and the flat block kernel
    on the joined state; then one mat step at each rung, timed."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, split_tables)
    from gpu_quantum_simulator_tpu_torch.kernels.split import (
        run_split_block, run_split_block_plain)

    n = SPLIT_WIDTH
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    logt = int(np.log2(PF.tile_rows(n)))
    kind_perm = logt + 1
    index_only = PF._Block(
        kinds=[logt, kind_perm, 1, kind_perm, 4, kind_perm],
        midx=[0, 0, 0, 5, 0, 2])
    one_mat = PF._Block(kinds=[0], midx=[0], mats=[
        (random_unitary(rng, 128), tuple(range(7)), None)])
    blocks = [synthetic_blocks(PF, rng, logt)[0], index_only, one_mat]
    scal, a_tab, b_tab, mono_src = split_tables_for(torch, PF, blocks,
                                                    PF.CAP_MATS)
    w16 = split_tables(a_tab, b_tab)
    h = random_halves(torch, n)
    tols = {"highest": SPLIT_MAT_TOL, "high": BLOCK_TOL}
    err = {}
    for i, name in enumerate(("every step kind", "index steps only")):
        for rung in ("highest", "high")[: 2 - i]:
            args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
            got = run_split_block(scal[i], clone4(h), *args, precision=rung,
                                  w16=w16[i])
            want = run_split_block_plain(scal[i], clone4(h), *args,
                                         precision=rung)
            flat = run_block(scal[i], *joined(torch, h), *args,
                             precision=rung, w16=w16[i])
            torch.cuda.synchronize()
            e, e_flat = diff4(got, want), diff4(joined(torch, got), flat)
            print(f"split block n={n} {name} {rung}: max|diff| vs plain "
                  f"{e:.3e}, vs the flat block kernel {e_flat:.3e}")
            bar = 0.0 if i == 1 else tols[rung]
            if not (e <= bar and e_flat <= bar):
                raise AssertionError(f"split block {name} {rung}: {e}, "
                                     f"{e_flat} > {bar}")
            err[rung] = max(err.get(rung, 0.0), e)
            del got, want, flat
    args = (a_tab[0], b_tab[0], mono_src[0], logt, PF.CAP_STEPS)
    ms = device_ms(torch, lambda: run_split_block(scal[0], h, *args), reps=5)
    plain_ms = device_ms(torch, lambda: run_split_block_plain(
        scal[0], h, *args), reps=3)
    pair = joined(torch, h)
    scratch = (torch.empty_like(pair[0]), torch.empty_like(pair[1]))
    flat_ms = device_ms(torch, lambda: run_block(scal[0], *pair, *args,
                                                 scratch=scratch), reps=5)
    kinds = [int(k) for k in scal[0][4 : 4 + int(scal[0][0])]]
    mats, monos = kinds.count(0), kinds.count(logt + 2)
    bnd = bound(6.0 * R2 * 256 * 256 * mats,
                16.0 * R2 * 256 + mats * 2 * 256 * 256 * 4
                + monos * 3 * 256 * 4)
    print(f"split block n={n}, {len(kinds)}-step block ({mats} mat, {monos} "
          f"mono): kernel {ms:.4f} ms in place, flat block kernel "
          f"{flat_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"({bnd[1]})")
    block = record("split_block", SPLIT_SRC, SPLIT_TPU, err["highest"], ms,
                   plain_ms, bnd, None)
    del pair, scratch

    # one mat step, each rung: the kernel, the flat kernel, the plain
    # version, and the plain version without its imaginary-table products
    recs = {}
    i = 2
    args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
    dropped = (a_tab[i], torch.zeros_like(b_tab[i]), mono_src[i], logt,
               PF.CAP_STEPS)
    flop = 6.0 * R2 * 256 * 256
    for rung in ("highest", "high"):
        got = run_split_block(scal[i], clone4(h), *args, precision=rung,
                              w16=w16[i])
        want = run_split_block_plain(scal[i], clone4(h), *args,
                                     precision=rung)
        miss = run_split_block_plain(scal[i], clone4(h), *dropped,
                                     precision=rung)
        torch.cuda.synchronize()
        e, e_drop = diff4(got, want), diff4(got, miss)
        if not e <= tols[rung]:
            raise AssertionError(f"split mat step {rung}: {e} > {tols[rung]}")
        if not e_drop > tols[rung]:
            raise AssertionError(f"split mat step {rung}: dropped products "
                                 f"pass ({e_drop})")
        del want, miss
        reps = 10
        ms = device_ms(torch, lambda: run_split_block(
            scal[i], h, *args, precision=rung, w16=w16[i]), reps=reps)
        plain_ms = device_ms(torch, lambda: run_split_block_plain(
            scal[i], h, *args, precision=rung), reps=3)
        pair = joined(torch, h)
        scratch = (torch.empty_like(pair[0]), torch.empty_like(pair[1]))
        flat_ms = device_ms(torch, lambda: run_block(
            scal[i], *pair, *args, scratch=scratch, precision=rung,
            w16=w16[i]), reps=reps)
        library_ms = None
        if rung == "highest":
            x = torch.cat(joined(torch, h), 1)
            a, b = a_tab[i, 0], b_tab[i, 0]
            w = torch.cat([torch.cat([a, b], 1), torch.cat([-b, a], 1)], 0)
            want = run_split_block_plain(scal[i], clone4(h), *args)
            lib = torch.matmul(x, w)
            torch.cuda.synchronize()
            e_lib = max_diff((lib[:, :256], lib[:, 256:]),
                             joined(torch, want))
            if not e_lib <= tols[rung]:
                raise AssertionError(f"split mat step library call: {e_lib}")
            library_ms = device_ms(torch, lambda: torch.matmul(x, w),
                                   reps=reps)
            bnd = bound(flop, 16.0 * R2 * 256 + 2 * 256 * 256 * 4)
            del x, lib, want
        else:
            bnd = bound(3 * flop, 16.0 * R2 * 256 + 4 * 256 * 256 * 2,
                        BF16_FLOPS)
        print(f"split mat step n={n} {rung}: max|diff| vs plain {e:.3e}, "
              f"without the imaginary-table products {e_drop:.3e}; kernel "
              f"{ms:.4f} ms in place, flat kernel {flat_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              + ("none" if library_ms is None else f"{library_ms:.4f} ms")
              + f", bound {bnd[0]:.4f} ms ({bnd[1]})")
        recs[rung] = record(
            "split_mat_step" + ("_high" if rung == "high" else ""), SPLIT_SRC,
            SPLIT_TPU, e, ms, plain_ms, bnd, library_ms)
        del pair, scratch, got
    torch.cuda.empty_cache()
    return block, recs["highest"], recs["high"]


def check_xswap(torch):
    """Kernel 5(b) at n=24: the pair swap on the lowest and the highest
    tile bit, bit-exact, beside a permute-copy of the stacked halves."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.split import (
        run_xswap, run_xswap_plain)

    n = SPLIT_WIDTH
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    logt = int(np.log2(PF.tile_rows(n)))
    rb = n - PF.LOCAL_QUBITS
    h = random_halves(torch, n)
    rec = None
    for bit in (logt, rb - 1):
        got = run_xswap(clone4(h), bit)
        want = run_xswap_plain(clone4(h), bit)
        # stacked bits: lanes 0..6, row bit r at 7 + r, the half on top
        src = list(range(8 + rb))
        src[7 + bit], src[7 + rb] = 7 + rb, 7 + bit
        stack = stack4(torch, h)
        lib = bit_permute(stack, src)
        torch.cuda.synchronize()
        if not equal4(torch, got, want):
            raise AssertionError(f"xswap row bit {bit}: differs from plain")
        if not torch.equal(lib, stack4(torch, got)):
            raise AssertionError(f"xswap row bit {bit}: permute-copy differs")
        ms = device_ms(torch, lambda: run_xswap(h, bit))
        plain_ms = device_ms(torch, lambda: run_xswap_plain(h, bit))
        library_ms = device_ms(torch, lambda: bit_permute(stack, src))
        bnd = bound(0.0, 8.0 * R2 * 256)     # half the state, read + written
        print(f"xswap kernel n={n} row bit {bit}: bit-exact; kernel "
              f"{ms:.4f} ms ({8.0 * R2 * 256 / ms / 1e6:.0f} GB/s), plain "
              f"{plain_ms:.4f} ms, permute-copy {library_ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms")
        if rec is None:
            rec = record("split_xswap", SPLIT_SRC, SPLIT_TPU, 0.0, ms,
                         plain_ms, bnd, library_ms)
        del got, want, lib, stack
    return rec


def check_pair_mode(torch, rng):
    """Kernel 6 at n=24: the first launch of a block reads its input
    through the pending cross-tile swap.  Against "pair swap, then the
    plain block" and against the plain version."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import split_tables
    from gpu_quantum_simulator_tpu_torch.kernels.split import (
        run_split_block, run_split_block_plain, run_xswap)

    n = SPLIT_WIDTH
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    rb = n - PF.LOCAL_QUBITS
    logt = int(np.log2(PF.tile_rows(n)))
    kind_perm, kind_mono = logt + 1, logt + 2
    shift = 3
    bit = logt + shift
    pro = (1 << shift, shift)
    u = random_unitary(rng, 128)
    mono = random_monomial(rng, 128)
    named = [
        ("mat-first", PF._Block(kinds=[0, 2], midx=[0, 0], prologue=pro,
                                mats=[(u, tuple(range(7)), None)])),
        ("mono-first", PF._Block(kinds=[kind_mono, kind_perm], midx=[0, 4],
                                 prologue=pro,
                                 mats=[(mono, tuple(range(7)), None)])),
        ("perm1-first", PF._Block(kinds=[kind_perm, logt], midx=[1, 0],
                                  prologue=pro)),
        ("perm5-first", PF._Block(kinds=[kind_perm], midx=[5], prologue=pro)),
        ("tswap1-first", PF._Block(kinds=[1, kind_perm], midx=[0, 3],
                                   prologue=pro)),
        ("swap-only", PF._Block(prologue=pro)),
        ("tswap-only", PF._Block(kinds=[logt], midx=[0], prologue=pro)),
    ]
    scal, a_tab, b_tab, mono_src = split_tables_for(
        torch, PF, [b for _, b in named], 2, inplace=True, fold_xswap=True)
    w16 = split_tables(a_tab, b_tab)
    h = random_halves(torch, n)
    tols = {"highest": SPLIT_MAT_TOL, "high": BLOCK_TOL}
    err = 0.0
    for i, (name, _) in enumerate(named):
        assert scal[i][1] == 1 and scal[i][3] == shift
        args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
        plain_row = scal[i].copy()
        plain_row[1] = 0
        for rung in ("highest", "high") if name == "mat-first" else ("highest",):
            kw = dict(precision=rung, w16=w16[i])
            one = run_split_block(scal[i], clone4(h), *args, **kw)
            two = run_split_block(plain_row, run_xswap(clone4(h), bit),
                                  *args, **kw)
            want = run_split_block_plain(scal[i], clone4(h), *args,
                                         precision=rung)
            torch.cuda.synchronize()
            e, e_two = diff4(one, want), diff4(one, two)
            print(f"pair mode n={n} row bit {bit} {name} {rung}: max|diff| "
                  f"vs pair swap then block {e_two:.3e}, vs plain {e:.3e}")
            exact = name not in ("mat-first", "mono-first")
            bar = 0.0 if exact else tols[rung]
            if e_two != 0.0 and name != "mat-first":
                raise AssertionError(f"pair mode {name}: not the swap then "
                                     f"the block bit for bit ({e_two})")
            if not (e <= bar and e_two <= bar):
                raise AssertionError(f"pair mode {name} {rung}: {e}, {e_two}")
            if name == "mat-first":
                miss = run_split_block_plain(
                    scal[i], clone4(h), a_tab[i], torch.zeros_like(b_tab[i]),
                    *args[2:], precision=rung)
                e_drop = diff4(one, miss)
                if not e_drop > bar:
                    raise AssertionError(f"pair mode mat {rung}: dropped "
                                         f"products pass ({e_drop})")
                del miss
            err = max(err, e)
            del one, two, want
    # one pair-mode launch (a tswap) beside the two launches it replaces
    i = len(named) - 1
    args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
    plain_row = scal[i].copy()
    plain_row[1] = 0
    ms = device_ms(torch, lambda: run_split_block(scal[i], h, *args))
    plain_ms = device_ms(torch, lambda: run_split_block_plain(scal[i], h,
                                                              *args), reps=5)
    two_ms = device_ms(torch, lambda: run_split_block(
        plain_row, run_xswap(h, bit), *args))
    # out(half, a, b) = in(b, half, a): output bit B holds input bit src[B]
    top, a_bit, b_bit = 7 + rb, 7 + logt - 1, 7 + bit
    src = list(range(8 + rb))
    src[top], src[a_bit], src[b_bit] = a_bit, b_bit, top
    stack = stack4(torch, h)
    got = run_split_block(scal[i], clone4(h), *args)
    lib = bit_permute(stack, src)
    torch.cuda.synchronize()
    if not torch.equal(lib, stack4(torch, got)):
        raise AssertionError("pair-mode tswap: the permute-copy differs")
    library_ms = device_ms(torch, lambda: bit_permute(stack, src))
    # six of the orbit's eight elements move: read and written once
    bnd = bound(0.0, 0.75 * 16.0 * R2 * 256)
    print(f"pair-mode tswap launch n={n}: kernel {ms:.4f} ms, pair swap + "
          f"tswap kernels {two_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"permute-copy {library_ms:.4f} ms, bound {bnd[0]:.4f} ms")
    return record("split_pair_mode", SPLIT_SRC, STREAM_SPLIT_TPU, err, ms,
                  plain_ms, bnd, library_ms)


def check_inplace_relayout(torch):
    """Kernel 4 at n=24: an involution with fixed slots and one without,
    bit-exact against its plain version and the out-of-place kernel."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.relayout import (
        relayout_sources, run_relayout, run_relayout_inplace,
        run_relayout_inplace_plain)

    n = SPLIT_WIDTH
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    tr = PF.relayout_rows(n)
    m = int(np.log2(R2 // tr))
    some = list(range(m))
    some[0], some[3], some[5], some[m - 1] = 3, 0, m - 1, 5
    every = [a ^ 1 for a in range(m)]
    h = random_halves(torch, n)
    rec = None
    for name, sigma in (("with fixed slots", some), ("no fixed slot", every)):
        got = run_relayout_inplace(sigma, clone4(h), tr)
        want = run_relayout_inplace_plain(sigma, clone4(h), tr)
        flat = run_relayout(sigma, *joined(torch, h), tr)
        # per half: lanes 0..6, then the row bits; blocks of tr rows
        b0 = 7 + int(np.log2(tr))
        src = list(range(7 + n - PF.LOCAL_QUBITS))
        for a, s in enumerate(sigma):
            src[b0 + int(s)] = b0 + a
        stack = torch.stack(h).reshape(4, -1)
        lib = bit_permute(stack, src)
        torch.cuda.synchronize()
        if not (equal4(torch, got, want)
                and equal4(torch, joined(torch, got), flat)):
            raise AssertionError(f"in-place relayout {name}: differs")
        if not torch.equal(lib, torch.stack(got).reshape(4, -1)):
            raise AssertionError(f"in-place relayout {name}: permute-copy")
        srcs = relayout_sources(sigma, R2 // tr)
        moved = int((srcs != np.arange(R2 // tr)).sum())
        ms = device_ms(torch, lambda: run_relayout_inplace(sigma, h, tr))
        plain_ms = device_ms(torch, lambda: run_relayout_inplace_plain(
            sigma, h, tr), reps=5)
        library_ms = device_ms(torch, lambda: bit_permute(stack, src))
        nbytes = 2.0 * moved * tr * 128 * 4 * 4
        bnd = bound(0.0, nbytes)
        print(f"in-place relayout n={n} sigma={sigma} ({name}; {moved} of "
              f"{R2 // tr} blocks move): bit-exact; kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
              f"out-of-place permute-copy {library_ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms")
        if name == "no fixed slot":
            rec = record("relayout_inplace", RELAYOUT_SRC,
                         INPLACE_RELAYOUT_TPU, 0.0, ms, plain_ms, bnd,
                         library_ms)
        del got, want, flat, lib, stack
    return rec


FLAT_KINDS = ("mat", "mat_high", "gather", "folded", "relayout", "kh0",
              "kh0_high", "block128", "vmem")


def check_inplace_counts(n, counts, modes, runs, high):
    """Launches of ``runs`` in-place runs by kind against the plan's scal
    rows by mode; no flat kernel launched."""
    flat = {k: counts[k] for k in FLAT_KINDS if counts[k]}
    if flat:
        raise AssertionError(f"n={n} in place: flat kernels launched {flat}")
    for kind, mode in (("xswap", 2), ("split_pair", 1),
                       ("relayout_inplace", 3)):
        if counts[kind] != runs * modes.get(mode, 0):
            raise AssertionError(
                f"n={n} in place: {counts[kind]} {kind} launches for "
                f"{modes.get(mode, 0)} mode-{mode} rows x {runs} runs")
    # a pair-mode first launch may be the block's only mat step, so the
    # rung shows in the plain mat launches of either kind
    if counts["split_mat_high" if not high else "split_mat"]:
        raise AssertionError(f"n={n} in place: mat launches {counts} at "
                             f"high={high}")
    if not counts["split_mat_high" if high else "split_mat"] > 0:
        raise AssertionError(f"n={n} in place: no mat launch ({counts})")


def inplace_program(T, PF, c, precision, fold):
    """The in-place program of ``c`` as ``run_prefetch`` builds it, with
    the ``fold_xswap`` arm chosen (the config has no field for it)."""
    from gpu_quantum_simulator_tpu_torch.config import resolve_precision
    from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline
    from gpu_quantum_simulator_tpu_torch.passes.permute import plan_permutation

    n = c.num_qubits
    cfg = T.SimulatorConfig(strategy="prefetch", prefetch_inplace=True)
    perm = plan_permutation(c)
    max_high, cap_mats, window = PF.resolve_prefetch_knobs(cfg, n, True)
    ops = _fuse_pipeline(c.relabeled(perm), PF.LANE_QUBITS,
                         max_high=max_high, window=window)
    return PF.build_prefetch_program(
        ops, n, precision=resolve_precision(precision, n), cap_mats=cap_mats,
        final_layout=np.argsort(perm), device="cuda", inplace=True,
        fold_xswap=fold)


def run_folded_arm(torch, T, PF, c, precision):
    """One run of the ``fold_xswap`` program from |0...0>: (host state,
    seconds, launch counts, scal rows by mode)."""
    from gpu_quantum_simulator_tpu_torch.ops.apply import join_state

    PF._PROGRAM_CACHE.clear()
    prog = inplace_program(T, PF, c, precision, True)
    reset_counts()
    t0 = time.perf_counter()
    parts = prog.run_parts(*PF.initial_halves(c.num_qubits))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    state = join_state(*PF.join_halves(*parts))
    PF._PROGRAM_CACHE.clear()
    return state, secs, counts, dict(prog.mode_rows)


def run_inplace_path(torch, T, refs, add):
    """``prefetch_inplace=True`` at the widths of the flat path, both arms."""
    from gpu_quantum_simulator_tpu_torch import sampling as SP
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.ref.native import simulate_native

    def sim(precision="auto"):
        return T.Simulator(T.SimulatorConfig(
            strategy="prefetch", prefetch_inplace=True, precision=precision),
            device="cuda")

    # every width down to the engine's floor, both rungs: "highest"
    # against the f64 reference, "high" by its norm
    worst = 0.0
    for n in INPLACE_SMALL:
        c = T.models.grover_like(n, 60 * n, n)
        reset_counts()
        got = sim("highest").run(c)
        parts, _ = sim("high").run_device_halves(c)
        counts = launch_counts()
        add(counts)
        err = float(np.max(np.abs(got - simulate_native(c))))
        norm = SP.norm_halves(*parts)
        worst = max(worst, err)
        if not (err <= AMP_TOL and abs(norm - 1.0) <= NORM_TOL):
            raise AssertionError(f"in place n={n}: max|amp diff| {err}, "
                                 f"'high' norm_halves {norm}")
        if not (counts["split_mat"] and counts["split_mat_high"]
                and not any(counts[k] for k in FLAT_KINDS)):
            raise AssertionError(f"in place n={n}: launches {counts}")
    print(f"in place n={INPLACE_SMALL.start}..{INPLACE_SMALL.stop - 1}: "
          f"worst max|amp - f64| {worst:.3e} at 'highest'; 'high' norms "
          f"within {NORM_TOL}")
    PF._RUN_CACHE.clear()
    PF._PROGRAM_CACHE.clear()

    for n in INPLACE_WIDTHS:
        c = T.models.grover_like(n, 2445, 318)
        res, secs, counts, modes = drive(torch, PF, sim(), c, ENGINE_RUNS)
        add(counts)
        err = float(np.max(np.abs(res.state - refs[n])))
        report(n, res, secs, counts, f"in place; max|amp - f64| {err:.3e}; "
               f"scal rows by mode {modes}")
        if not err <= AMP_TOL:
            raise AssertionError(f"in place n={n}: max|amp diff| {err}")
        check_inplace_counts(n, counts, modes, ENGINE_RUNS + 1, False)
        if not (modes.get(2, 0) and (n < 22 or modes.get(3, 0))):
            raise AssertionError(f"in place n={n}: no pair swap or relayout "
                                 f"in the plan ({modes})")

        # the halves as they are, their norm, and the join
        parts, nops = sim().run_device_halves(c)
        norm = SP.norm_halves(*parts)
        re, im, _ = sim().run_device(c)
        jre, jim = PF.join_halves(*parts)
        if not (torch.equal(jre, re) and torch.equal(jim, im)):
            raise AssertionError(f"in place n={n}: run_device_halves joined "
                                 "differs from run_device")
        if not abs(norm - 1.0) <= NORM_TOL:
            raise AssertionError(f"in place n={n}: norm_halves {norm}")
        del parts, re, im, jre, jim

        state, fsecs, fcounts, fmodes = run_folded_arm(torch, T, PF, c, "auto")
        add(fcounts)
        ferr = float(np.max(np.abs(state - refs[n])))
        print(f"in place n={n} fold_xswap: {fsecs:.4f} s; max|amp - f64| "
              f"{ferr:.3e}; norm_halves {norm:.8f}; scal rows by mode "
              f"{fmodes}; launches {fcounts}")
        if not ferr <= AMP_TOL:
            raise AssertionError(f"fold_xswap n={n}: max|amp diff| {ferr}")
        check_inplace_counts(n, fcounts, fmodes, 1, False)
        if 2 in fmodes or fmodes.get(1, 0) != modes.get(2, 0):
            raise AssertionError(f"fold_xswap n={n}: modes {fmodes} against "
                                 f"the hoisted plan's {modes}")

    # a resume on the card: the rest of the benchmark circuit from the
    # halves of a run of its first part, and from their flat pair, both on
    # the device (the plan relabels the qubits, so both forms are relabeled
    # there first)
    from gpu_quantum_simulator_tpu_torch.ops.apply import join_state

    n = INPLACE_WIDTHS[1]
    c = T.models.grover_like(n, 2445, 318)
    first, second = T.Circuit(n), T.Circuit(n)
    first.gates, second.gates = c.gates[:RESUME_AT], c.gates[RESUME_AT:]
    parts, _ = sim().run_device_halves(first)
    pair = PF.join_halves(*parts)
    held = [x.clone() for x in parts]
    reset_counts()
    from_halves, _ = sim().run_device_halves(second, initial_parts=parts)
    from_pair, _ = sim().run_device_halves(second, initial_parts=pair)
    counts = launch_counts()
    add(counts)
    err = float(np.max(np.abs(join_state(*PF.join_halves(*from_halves))
                              - refs[n])))
    same = equal4(torch, from_halves, from_pair)
    kept = equal4(torch, parts, held)       # the caller's halves: copied
    print(f"in place n={n} resumed after gate {RESUME_AT} from device "
          f"halves and from a device flat pair: equal {same}; the given "
          f"halves unchanged {kept}; max|amp - f64| {err:.3e}; launches "
          f"{counts}")
    if not (same and kept and err <= AMP_TOL):
        raise AssertionError(f"in place n={n} resume: equal {same}, "
                             f"unchanged {kept}, max|amp diff| {err}")
    del parts, pair, held, from_halves, from_pair

    # n=24: "high" against the engine's own "highest" run, both arms
    n = HIGH_WIDTH
    c = T.models.grover_like(n, 2445, 318)
    res, secs, counts, modes = drive(torch, PF, sim(), c, ENGINE_RUNS)
    add(counts)
    ref, ref_secs, ref_counts, ref_modes = drive(torch, PF, sim("highest"),
                                                 c, 0)
    add(ref_counts)
    err = float(np.max(np.abs(res.state - ref.state)))
    norm = float(np.linalg.norm(res.state))
    report(n, res, secs, counts, f"in place 'high' vs 'highest' max|diff| "
           f"{err:.3e} ('highest' run {ref_secs[0]:.4f} s, launches "
           f"{ref_counts}); norm {norm:.8f}; scal rows by mode {modes}")
    if not 0.0 < err <= HIGH_TOL:
        raise AssertionError(f"in place n={n}: 'high' vs 'highest' {err}")
    if not abs(norm - 1.0) <= NORM_TOL:
        raise AssertionError(f"in place n={n}: norm {norm}")
    check_inplace_counts(n, counts, modes, ENGINE_RUNS + 1, True)
    check_inplace_counts(n, ref_counts, ref_modes, 1, False)
    state, fsecs, fcounts, fmodes = run_folded_arm(torch, T, PF, c, "auto")
    add(fcounts)
    ferr = float(np.max(np.abs(state - ref.state)))
    print(f"in place n={n} fold_xswap 'high': {fsecs:.4f} s; vs 'highest' "
          f"{ferr:.3e}; scal rows by mode {fmodes}; launches {fcounts}")
    if not 0.0 < ferr <= HIGH_TOL:
        raise AssertionError(f"fold_xswap n={n}: 'high' vs 'highest' {ferr}")
    check_inplace_counts(n, fcounts, fmodes, 1, True)
    PF._RUN_CACHE.clear()
    PF._PROGRAM_CACHE.clear()


def chi_square(samples, probs, n):
    """Pearson chi-square of the samples' histogram over SAMPLE_BINS bins of
    equal index ranges against the exact probabilities, bins expecting fewer
    than 5 samples pooled into one; returns (chi2, degrees of freedom)."""
    shift = n - int(np.log2(SAMPLE_BINS))
    obs = np.bincount(samples >> shift, minlength=SAMPLE_BINS).astype(float)
    exp = probs.reshape(SAMPLE_BINS, -1).sum(axis=1)
    exp *= len(samples) / exp.sum()
    small = exp < 5.0
    obs = np.append(obs[~small], obs[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    keep = exp > 0
    return (float((((obs - exp) ** 2)[keep] / exp[keep]).sum()),
            int(keep.sum()) - 1)


def run_sampling(torch, T, refs):
    """sampling.py on the card: the flat samplers at n=23, the halves ones
    at n=22 with ``prefetch_inplace=True``, against the f64 reference."""
    from gpu_quantum_simulator_tpu_torch import sampling as SP

    def z_exact(probs, qubits):
        idx = np.arange(probs.size)
        par = np.zeros(probs.size, dtype=np.int64)
        for q in qubits:
            par ^= (idx >> q) & 1
        return float((probs * (1 - 2 * par)).sum())

    def check(kind, n, samples, probs, z, z_want, top_idx, top_p):
        chi2, dof = chi_square(samples, probs, n)
        bar = dof + 6.0 * np.sqrt(2.0 * dof)
        order = np.sort(probs)[::-1][: len(top_p)]
        e_top = max(float(np.max(np.abs(top_p - order))),
                    float(np.max(np.abs(probs[top_idx] - top_p))))
        print(f"sampling n={n} {kind}: {len(samples)} samples, chi-square "
              f"{chi2:.1f} on {dof} degrees of freedom (bar {bar:.1f}); "
              f"<Z..Z> {z:.8f} (f64 {z_want:.8f}); top-{len(top_p)} "
              f"probabilities within {e_top:.3e}")
        if not (samples.min() >= 0 and samples.max() < (1 << n)):
            raise AssertionError(f"sampling {kind}: index out of range")
        if not chi2 <= bar:
            raise AssertionError(f"sampling {kind}: chi-square {chi2} > {bar}")
        if not abs(z - z_want) <= 1e-5:
            raise AssertionError(f"sampling {kind}: <Z..Z> {z} vs {z_want}")
        if not e_top <= 1e-6:
            raise AssertionError(f"sampling {kind}: top amplitudes {e_top}")

    n = 23
    c = T.models.grover_like(n, 2445, 318)
    probs = np.abs(refs[n]) ** 2
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cuda")
    re, im, _ = sim.run_device(c)
    samples = SP.sample_state_device(re, im, n, SAMPLES, seed=11)
    qubits = (0, 5, 7, 22)
    top_p, top_idx = SP.top_amplitudes_device(re, im, 16)
    check("flat", n, samples, probs, SP.expectation_z(re, im, qubits, n),
          z_exact(probs, qubits), top_idx, top_p)
    if not np.array_equal(samples, sim.sample(c, SAMPLES, seed=11)):
        raise AssertionError("Simulator.sample differs from "
                             "sample_state_device at the same seed")
    if not abs(SP.norm_device(re, im) - 1.0) <= NORM_TOL:
        raise AssertionError("norm_device")
    xeb = SP.xeb_fidelity(re, im, samples, n)
    want = float((1 << n) * (probs ** 2).sum() - 1.0)
    print(f"sampling n={n} flat: XEB fidelity of its own samples {xeb:.4f} "
          f"(2^n sum p^2 - 1 = {want:.4f})")
    del re, im

    n = 22
    c = T.models.grover_like(n, 2445, 318)
    probs = np.abs(refs[n]) ** 2
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch",
                                        prefetch_inplace=True), device="cuda")
    parts, _ = sim.run_device_halves(c)
    samples = SP.sample_halves(*parts, n, SAMPLES, seed=12)
    qubits = (3, 7, 15, 21)
    top_idx, top_p = SP.top_amplitudes_halves(*parts, k=16)
    check("halves", n, samples, probs,
          SP.expectation_z_halves(*parts, qubits, n), z_exact(probs, qubits),
          top_idx, top_p)
    idx = np.concatenate([top_idx, np.random.default_rng(22).integers(
        0, 1 << n, 4096)])
    e_amp = float(np.max(np.abs(SP.amplitudes_halves(*parts, idx)
                                - refs[n][idx])))
    print(f"sampling n={n} halves: amplitudes_halves at {len(idx)} indices "
          f"within {e_amp:.3e} of f64")
    if not e_amp <= AMP_TOL:
        raise AssertionError(f"amplitudes_halves: {e_amp}")
    if not np.array_equal(samples, SP.sample_halves(*parts, n, SAMPLES,
                                                    seed=12)):
        raise AssertionError("sample_halves is not reproducible from its seed")


def clear_caches(torch):
    """Drop every engine's cached programs, and with them their device
    tables, so that a peak-memory reading starts from an empty card."""
    from gpu_quantum_simulator_tpu_torch.engine import pallas_engine as PE
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S
    from gpu_quantum_simulator_tpu_torch.engine import vmem as V
    from gpu_quantum_simulator_tpu_torch.engine import wide as W

    for cache in (PF._PROGRAM_CACHE, PF._RUN_CACHE, S._MXU_PLAN_CACHE,
                  W._CACHE, PE._CACHE, V._CACHE):
        cache.clear()
    gc.collect()
    torch.cuda.empty_cache()


def run_full_width(torch, T, add):
    """n=30 with the prefetch strategy and nothing else set: in place,
    "high", through run_device_halves; then the flat run beside it."""
    from gpu_quantum_simulator_tpu_torch import sampling as SP
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF

    n = FULL_WIDTH
    gib = float(1 << 30)
    state_bytes = 8 << n
    c = T.models.grover_like(n, 2445, 318)
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cuda")
    clear_caches(torch)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    parts, nops = sim.run_device_halves(c)
    cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    add(counts)
    (prog,) = PF._RUN_CACHE.values()
    modes = dict(prog.mode_rows)
    norm = SP.norm_halves(*parts)
    print(f"full width n={n} in place: {nops} steps; first run {cold:.2f} s "
          f"(fusion, plan and tables included); peak device memory "
          f"{peak / gib:.3f} GiB for a state of {state_bytes / gib:.0f} GiB "
          f"({held / gib:.3f} GiB held before the run); "
          f"norm_halves {norm:.8f}; scal rows by mode {modes}; launches "
          f"{counts}")
    if not (prog.inplace and all(p.shape == (1 << (n - 8), 128)
                                 for p in parts)):
        raise AssertionError("n=30 did not run in place on four halves")
    if not abs(norm - 1.0) <= FULL_NORM_TOL:
        raise AssertionError(f"n={n}: norm_halves {norm}, bar {FULL_NORM_TOL}")
    if not peak <= state_bytes + FULL_PEAK_SLACK:
        raise AssertionError(f"n={n}: peak {peak} B exceeds the state + 2 GiB")
    check_inplace_counts(n, counts, modes, 1, True)

    top_idx, top_p = SP.top_amplitudes_halves(*parts, k=64)
    idx = np.concatenate([top_idx, np.random.default_rng(n).integers(
        0, 1 << n, 4096)])
    amps = SP.amplitudes_halves(*parts, idx)
    samples = SP.sample_halves(*parts, n, 10000, seed=7)
    del parts
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = sim.sample(c, 10000, seed=7)       # a second run, program cached
    warm = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated()
    add(launch_counts())
    print(f"full width n={n} in place: Simulator.sample(10000) {warm:.2f} s "
          f"(the run with its program cached, and the sampling; peak "
          f"{peak2 / gib:.3f} GiB); indices in [{again.min()}, "
          f"{again.max()}]")
    if not (again.shape == (10000,) and again.min() >= 0
            and again.max() < (1 << n)):
        raise AssertionError("n=30: samples out of range")
    if not np.array_equal(again, samples):
        raise AssertionError("n=30: Simulator.sample differs from "
                             "sample_halves of the same state and seed")

    flat = T.Simulator(T.SimulatorConfig(strategy="prefetch",
                                         prefetch_inplace=False),
                       device="cuda")
    clear_caches(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    re, im, _ = flat.run_device(c)
    flat_cold = time.perf_counter() - t0
    flat_peak = torch.cuda.max_memory_allocated()
    flat_counts = launch_counts()
    add(flat_counts)
    where = torch.from_numpy(idx).cuda()
    want = (re[where].cpu().numpy().astype(np.complex64)
            + 1j * im[where].cpu().numpy())
    del re, im
    err = float(np.max(np.abs(amps - want)))
    peak_amp = float(np.sqrt(top_p[0]))
    tol = HIGH_TOL * max(1.0, peak_amp / HIGH_BAR_PEAK)
    print(f"full width n={n} flat (prefetch_inplace=False): first run "
          f"{flat_cold:.2f} s (fusion, plan and tables included); peak "
          f"device memory {flat_peak / gib:.3f} GiB; launches "
          f"{flat_counts}; in place vs flat at the top-64 and 4096 random "
          f"indices max|diff| {err:.3e} (bar {tol:.3e}, peak |amp| "
          f"{peak_amp:.3e})")
    if not flat_peak > 2 * state_bytes:
        raise AssertionError(f"n={n} flat: peak {flat_peak} B is not above "
                             "two states")
    if not err <= tol:
        raise AssertionError(f"n={n}: in place vs flat {err} > {tol}")
    clear_caches(torch)


def run_inplace_phase(torch, T, refs, add, rng):
    """Phase 5: the kernel checks, the path, sampling, and full width."""
    block, mat, high = check_split_block(torch, rng)
    xswap = check_xswap(torch)
    pair = check_pair_mode(torch, rng)
    relayout = check_inplace_relayout(torch)
    torch.cuda.empty_cache()
    run_inplace_path(torch, T, refs, add)
    run_sampling(torch, T, refs)
    run_full_width(torch, T, add)
    return ((block, "split_gather"), (mat, "split_mat"),
            (high, "split_mat_high"), (xswap, "xswap"), (pair, "split_pair"),
            (relayout, "relayout_inplace"))


# ------------------------------------- phase 6: the public op and the probe
def check_butterfly(torch, rng, add):
    """Kernel 10, the public op ``apply_butterfly_high`` at n=30 (no engine
    calls it, as in the JAX package): three random 2 x 2 unitaries on row
    bits 0, 11 and 22 of a normalised random state, each against its plain
    version (<= 1e-6), in place against out of place (bit-exact), timed
    beside the plain version and ``ops/apply.py`` ``apply_1q`` on the same
    state."""
    from gpu_quantum_simulator_tpu_torch.ops import pallas_kernels as PK
    from gpu_quantum_simulator_tpu_torch.ops.apply import apply_1q

    n = BUTTERFLY_WIDTH
    R = 1 << (n - PK.LANE_QUBITS)
    re, im = (torch.randn(R, PK.LANES, device="cuda") for _ in range(2))
    scale = norm2((re, im)) ** -0.5
    re.mul_(scale)
    im.mul_(scale)
    gates = [random_unitary(rng, 2) for _ in range(3)]
    out = (torch.empty_like(re), torch.empty_like(im))
    if PK.apply_butterfly_high.launches:
        raise AssertionError("kernel 10 was launched on an engine path")
    PK.reset_launches()
    err = 0.0
    for hb in BUTTERFLY_BITS:
        for u in gates:
            PK.apply_butterfly_high(re, im, u, hb, out=out)
            want = PK.apply_butterfly_high_plain(re, im, u, hb)
            torch.cuda.synchronize()
            err = max(err, max_diff(out, want))
            del want
    launches = PK.apply_butterfly_high.launches
    add({"butterfly": launches})
    own = (re.clone(), im.clone())
    PK.apply_butterfly_high(*own, gates[0], 0, out=own)
    PK.apply_butterfly_high(re, im, gates[0], 0, out=out)
    inplace_ok = torch.equal(own[0], out[0]) and torch.equal(own[1], out[1])
    del own
    torch.cuda.empty_cache()
    times = {hb: device_ms(torch, lambda hb=hb: PK.apply_butterfly_high(
        re, im, gates[0], hb, out=out), reps=5, rounds=3)
        for hb in BUTTERFLY_BITS}
    hb = BUTTERFLY_BITS[-1]
    plain_ms = device_ms(torch, lambda: PK.apply_butterfly_high_plain(
        re, im, gates[0], hb), reps=2, rounds=3)
    ur = torch.tensor(gates[0].real, dtype=torch.float32, device="cuda")
    ui = torch.tensor(gates[0].imag, dtype=torch.float32, device="cuda")
    lib_ms = device_ms(torch, lambda: apply_1q(
        re.view(-1), im.view(-1), ur, ui, hb + PK.LANE_QUBITS, n),
        reps=2, rounds=3)
    bnd = bound(nbytes=2.0 * 8 * (1 << n))  # the state read and written once
    ms = max(times.values())
    print(f"butterfly n={n}: kernel " + ", ".join(
        f"high_bit {b} {t:.4f} ms" for b, t in times.items())
        + f"; plain {plain_ms:.4f} ms, apply_1q {lib_ms:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}, {bnd[0] / ms:.1%} of it reached); "
        f"max|diff| vs plain {err:.3e} over {launches} launches; in place "
        f"{'bit-exact' if inplace_ok else 'DIFFERS'}")
    if not (err <= BUTTERFLY_TOL and inplace_ok and launches == 9):
        raise AssertionError(f"butterfly n={n}: max|diff| {err}, in place "
                             f"equal {inplace_ok}, launches {launches}")
    del re, im, out
    torch.cuda.empty_cache()
    return record("butterfly_high", BUTTERFLY_SRC, BUTTERFLY_TPU, err, ms,
                  plain_ms, bnd, lib_ms)


def check_copy_probes(torch, add):
    """Kernel 11, the copy probe harness (gpu_quantum_simulator_tpu_torch/
    dma_probe.py) at n = 24, 28 and 30: every route and tile shape copies
    bit for bit; GB/s per variant beside ``copy_``'s.  The records take each
    route's fastest pair copy at n=30, with its max |dst - src|."""
    from gpu_quantum_simulator_tpu_torch import dma_probe
    from gpu_quantum_simulator_tpu_torch.kernels import copy as KC

    routes = {"grid": ("grid2_", KC.grid_copy),
              "stream": ("stream_", KC.stream_copy),
              "direct": ("direct_", KC.hbm_direct)}
    launches = dict.fromkeys(routes, 0)
    if any(fn.launches for _, fn in routes.values()):
        raise AssertionError("a copy probe kernel ran on an engine path")
    for n in COPY_WIDTHS:
        KC.reset_launches()
        res = dma_probe.measure(n)
        for k, (_, fn) in routes.items():
            launches[k] += fn.launches
        print(f"copy probe n={n}: " + json.dumps(
            {k: v["GBps"] for k, v in res.items()}))
        bad = [k for k, v in res.items() if not v["exact"]]
        if bad:
            raise AssertionError(f"copy probe n={n}: not bit-exact: {bad}")
        torch.cuda.empty_cache()
    add({f"copy_{k}": v for k, v in launches.items()})
    lib = res["torch_copy"]
    bnd = bound(nbytes=2.0 * 8 * (1 << COPY_WIDTHS[-1]))
    recs = []
    for k, (prefix, _) in routes.items():
        name = max((v for v in res if v.startswith(prefix)),
                   key=lambda v: res[v]["GBps"])
        print(f"copy probe n={COPY_WIDTHS[-1]} {k}: fastest {name} "
              f"{res[name]['ms']:.4f} ms ({res[name]['GBps']:.1f} GB/s); "
              f"copy_ {lib['ms']:.4f} ms ({lib['GBps']:.1f} GB/s); bound "
              f"{bnd[0]:.4f} ms ({HBM_BYTES / 1e9:.0f} GB/s)")
        recs.append((record(f"copy_{k}", COPY_SRC, COPY_TPU[k],
                            res[name]["max_abs_err"], res[name]["ms"],
                            lib["ms"], bnd, lib["ms"]),
                     f"copy_{k}"))
    return recs


def run_main_path(torch, T, refs, add):
    highest24 = run_prefetch_path(torch, T, refs, add)
    run_mxu_path(torch, T, refs, highest24, add)
    run_pallas_path(torch, T, refs, add)
    run_vmem_path(torch, T, refs, add)
    run_small_widths(torch, T, refs, add)


def references(T, widths):
    """The f64 reference, once per width, shared by every strategy."""
    from gpu_quantum_simulator_tpu_torch.ref.native import simulate_native

    t0 = time.perf_counter()
    refs = {n: simulate_native(T.models.grover_like(n, 2445, 318))
            for n in sorted(widths)}
    print(f"f64 references n={sorted(refs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    return refs


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
    # phase 3's torch draws come from a seed, as its numpy draws do: the
    # "high" mat step's max |diff| over 2^29 values sits near its bar
    torch.manual_seed(2445)
    start = time.perf_counter()

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

    totals: dict = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    rng = np.random.default_rng(2445)
    # phase 3: each kernel against its plain version
    block, mat = check_block_kernel(torch, rng)
    relayout = check_relayout_kernel(torch, rng)
    folded = check_folded_block(torch, rng)
    high = check_high_mat(torch, rng)
    chain, chain_high, block128 = check_wide_chain(torch, rng)
    vmem_chunk, vmem_op = check_vmem_kernel(torch, T)
    check_high_drift(torch)
    torch.cuda.empty_cache()

    # phase 4: the main paths, counting launches; phase 5: the in-place
    # engine, its kernels first
    refs = references(T, set(REF_WIDTHS) | set(VMEM_WIDTHS))
    run_main_path(torch, T, refs, add)
    inplace = run_inplace_phase(torch, T, refs, add, rng)
    # phase 6: the public op (kernel 10) and the copy probes (kernel 11)
    butterfly = check_butterfly(torch, rng, add)
    copies = check_copy_probes(torch, add)
    kinds = ((block, "gather"), (mat, "mat"), (relayout, "relayout"),
             (folded, "folded"), (high, "mat_high"), (chain, "kh0"),
             (chain_high, "kh0_high"), (block128, "block128"),
             (vmem_chunk, "vmem"), (vmem_op, "vmem"), *inplace,
             (butterfly, "butterfly"), *copies)
    for rec, kind in kinds:
        rec["launches"] = totals[kind]
        if not rec["launches"] > 0:
            raise AssertionError(f"{rec['name']}: no launch on a main path")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec, _ in kinds]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
