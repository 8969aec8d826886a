#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, check, run.

    python3 chip_smoke.py

Drives ``gpu_quantum_simulator_tpu_torch`` (never JAX, never the JAX
package) through its main paths on the first CUDA device, in phases; any
failure raises and the script exits non-zero:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from the repository's sources (build/), and
   check in the library's SASS that both "high" mat-step kernels (flat and
   in place) run on wgmma (HGMMA, and no tf32 mma.sync k4), and so do
   the mxu mm step at every D and the chain kernel's "high" arm (HGMMA,
   and no mma.sync HMMA at all), at both rungs, printing the k-loop's
   instruction mix with the registers and spills ptxas reported;
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
   rungs (<= 1e-7; in place bit-exact; at "high" a chain of one product
   equal to the D = 128 mm step bit for bit) and one product as
   ``apply_block128`` (<= 1e-7), the mxu engine's "high" mm step
   (csrc/mm_high.cu) at n=24 on a normalized (R, 128) state read and
   written through the row map of D=512 and D=256 blocks (<= 1e-7; the
   plain version without one correction pass must miss that bar; timed
   beside the cuBLAS bf16 GEMMs and row shuffles it replaced),
   and the vmem chunk kernel (kernel 8) at
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
   runs) against the native f64 reference (computed once per width, on
   host threads while the card runs phase 3, and shared by every
   strategy; max |diff| <= 1e-6, norm within 1e-4 of 1);
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
   default config; at "high" the mm kernel's launches equal the plan's mm
   steps per run (no cuBLAS GEMM).  pallas: n=18 and 22 against the f64 reference
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
   step <= 1e-6, the "high" one <= 1e-5; one mat step alone at each rung
   bit for bit, both kernels keeping the same sums; the "high" step timed in
   place at n=30 too), two chains of in-place "high" steps launched
   alternately on two streams (each equal to its one-stream chain bit for
   bit, each stream's counters zero after), the pair swap (kernel 5(b)) on
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
7. the facade's program entry points, the launch counts set to 0 before
   each and read after.  ``run_device_iterated`` on Grover at n=24
   (``grover_parts(13, 5301)``, 71 repetitions) on mxu and flat prefetch
   at "auto" ("high") and "highest": the graph replays bit for bit the
   eager loop of the same body program, "high" against the unrolled
   circuit's ``run_device`` and "highest" against the exact f64 state
   (the rung's bar scaled with the peak amplitude and with the run's
   fused ops over the benchmark's), the peak at the marked state; host
   and device ms per repetition, graph against eager loop, the graph's
   pool and end copy.  Trotter TFIM at n=28 on mxu (norm, the entropy at
   the middle cut > 0), <H> of ``tfim_terms(28)`` by the "state" and
   "basis" methods at "highest" (1e-5 relative).  ``run_device_parts``
   at n=24: two halves equal the whole (the "high" bar), the caller's
   tensors unchanged.  ``run_many`` at n=24 over eight QAOA candidates:
   its dispatch under torch's sync debug mode "error", terms against
   ``expectation_pauli_sum`` (<= 1e-5), wall time against waiting per
   circuit.  Phase 5's n=30 state also runs the halves routes of
   ``observables.py`` against the flat ones (<= 1e-5).  ``join_state`` of
   parts on the card: bit for bit the plain numpy join of the parts
   fetched whole, float32 and float64, flat and (S, 2^n), strided, below
   one chunk, one chunk and 3.27 chunks (chunks of 64 elements), and at
   n=28 with the default chunk behind a queued second of device work
   (the output ready before the card: ``state_join_overlapped``),
   timed against the plain join; ``run_detailed`` at n=24 equal to the
   join of ``run_device``'s parts.
8. the CLI and the per-gate strategies: ``__main__.main([...])`` in this
   process (its launches count) on circuits written with ``to_qasm()``
   into a temporary directory.  The default config at n=24 (mxu, "high")
   with --json --save-state: the checkpoint equals ``Simulator().run`` of
   the same circuit bit for bit, and the parsed circuit hits the plan
   cache that run filled.  --strategy prefetch --precision highest at
   n=22 against the f64 reference (<= 1e-6).  --inplace at n=24: the
   first 1200 gates saved as halves, the rest resumed from that file,
   against the flat prefetch run of the whole circuit (twice the "high"
   bar).  One ``python -m gpu_quantum_simulator_tpu_torch`` process with
   no --device flag (exit 0, one float first).  The reference's ablation
   rows at n=18 on ``grover_like(18, 2445, 318)``: naive, fused2x2,
   fused3in1, fused4x4, scan, megakernel, mxu and prefetch, each the
   CLI's seconds over three runs after a warm-up, against the f64
   reference (per-gate bar 5e-6, mxu and prefetch 1e-6); naive and scan
   dispatched once more under torch's sync debug mode "error", equal to
   their CLI runs bit for bit, with their peak device memory.
9. the workloads on the state, through the ported entry points (their
   launches add to the totals; each step prints its seconds, most their
   peak reserved memory).  Gradients: ``adjoint_gradient`` against
   ``parameter_shift`` (``expectation_pauli_sum`` as the objective) on six
   tied gates of ``qaoa_maxcut_tied(20)`` on prefetch "highest" (<= 1e-4);
   the adjoint on the default config at n=24, timed, its forward and
   sweep queued again under sync debug "error" (equal to the timed call);
   ``make_adjoint_value_and_grad(tie=)`` at n=24 against the adjoint's
   per-gate gradients under the tie's chain rule (1e-4 of max|grad|);
   ``run_vqe``'s 40 steps at n=20 under sync debug "error" (energies[0]
   = fn(theta0), the cut rises), ``energy_landscape``'s chunks on a
   12 x 12 grid at n=16 under sync debug "error" (three points against
   ``fn``, 1e-5) and ``restarts=4`` at n=16 as one batched sweep (restart
   0 = the single run within 1e-4).  Dynamic circuits: a
   parsed QASM GHZ-20 with a mid-circuit measure, reset and conditional X
   as a 256-shot ensemble (n + s = 28, default config) under sync debug
   "error": every shot's 21 bits equal, every shot block's norm within
   1e-5 of 1; the public ``run_dynamic_batched`` (ones within 4 sigma of
   Binomial(256, 1/2)), the program caches' sizes; a per-gate noisy
   ensemble with the segments' pair handed over and copied (the copies'
   share); ``run_dynamic`` at n=12 equal to the CPU run's bits.  Noise:
   ``expectation_noisy`` at p = 0 against ``expectation_pauli_sum`` at
   n=20 (1e-5), at n=10 with 4096 shots against the density matrix of the
   same model (4 sigma, <Z0 Z1> and <X0 X1>), the noisy CLI route at n=20
   (-m 1024, readout flips, --json) and one ``zne_expectation`` at n=16.
   Density: n=12 (2n=24, prefetch "high") with depolarizing and damping
   channels (trace within 1e-5) and without (the diagonal against |psi|^2
   within the "high" bar), then GHZ-15 with dephasing on every qubit in
   place at 2n=30 (P(0..0), P(1..1) within 1e-5 of 1/2, trace within
   1e-5).  Shadows: 4000 snapshots of GHZ-20, <Z0 Z1> within 5 standard
   errors of 1.
10. the "default" rung (one bf16 pass) and complex128.  The four
   "default" kernels, the "high" bodies' LO = false instantiations (the
   mat step and the mm step on k-loops of their own and hi-only table
   images; SASS checked in phase 2): the mat step flat at n=24 and 28 and in
   place at n=24 (bit for bit the flat step) against its plain version
   (<= 1e-6 of the output's largest |value|), timed in place at n=30 too;
   the chain at n=24, P = 1 against its plain version and bit for bit the
   D = 128 mm step, P = 8 bit for bit eight P = 1 launches; the mm step
   at n=24, D = 512 and 256; each "default" arm bit for bit its "high"
   arm on bf16-exact state and tables, each timed beside the "high" arm,
   the plain version, one bf16 ``torch.mm`` of the real form and its
   bound.  The mat step's drift over 200 steps at n=24, six seeds, under
   phase 3's bars (the excess summed step by step: the two chains part at
   one pass).  Through the Simulator at "default", launches against the
   plans: prefetch flat n=18 against the f64 reference (in (1e-6, 1e-3]),
   n=24 against phase 4's "highest" state, in place at n=30 (norm, peak
   memory); mxu at n=24 (mm steps) and the low-only circuit (chains of
   8), within the Karatsuba bar scaled with the peak.  complex128 on mxu
   and the megakernel at n=20 (within 1e-9 of the f64 reference) and 24
   (within 1e-9 of each other), timed, with peak memory and no kernel
   launch.
11. the sharded engines (``strategy="sharded"``), their meshes repeating
   the card (``device=["cuda:0"] * k``): grover_like(23, 2445, 318) over
   8 shards at "highest" against the f64 reference (1e-6; gswaps > 0,
   counted once an entry); n=24 over 4 shards at "auto" ("high") against
   phase 4's "highest" state (the "high" bar); that state saved shard by
   shard and reloaded onto 4 and 2 shards, bit for bit; complex128 at
   n=20 over 4 shards through the dense engine (1e-9 of the f64
   reference); phase 7's Grover (n=24) through ``run_device_iterated``
   over 4 shards at "highest" against phase 7's flat result and the
   exact state; n=31 over 8 shards (nl=28): the mirror of
   grover_like(31, 400, 31) at "highest" (<0|psi> within 1e-5 of 1, norm
   within 1e-4), one timed run_device of grover_like(31, 2445, 318) at
   "auto" (planning, table and device seconds apart), the sampler on its
   sharded state, ``Simulator.sample`` of the mirror (every shot |0>),
   peak device memory <= 34 GiB.  Launch counts against each plan:
   relayouts once a shard and relayout row, gswaps once a gswap row, and
   the gswap kernel (csrc/gswap.cu) once a shard and gswap row.  That
   kernel against its plain version (torch view copies) on eight shards
   of 2^28 amplitudes, n=31's (``check_gswap_halves``): for each
   shard-index bit at the chain's local bit 7, one launch a shard and the
   new shards bit for bit those of the plain version, both timed.

Phase 3 also pins the "high" rung's norm drift: 200 chained "high" mat
steps at n=24 on a normalised random state over eight random unitary
tables, and 25 launches of the chain kernel's "high" arm (the mm step's
Karatsuba arithmetic on wgmma) with P = 8 random 128 x 128 unitaries
(200 products) at n=24, each for six seeds, the
drift printed after every step (launch) for the kernel and its plain
version; after 200 products the kernel's largest |1 - norm| over the seeds
may be at most 3 times the plain version's largest, and on every seed the
kernel's drift may differ from the plain version's by at most 2e-6.  The
mxu engine's "high" mm step (csrc/mm_high.cu) gets the same 200-step
measurement and bars on a kh = 2 block (D = 512, row bits 0 and 1) and a
kh = 1 block (D = 256, row bit 0).  At n=30 (phase
5) ``norm_halves`` must be within 1e-5 of 1.  Phase 3's relayout check
also times ``copy_`` of the same pair at n=22: the card's copy rate there.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Matmuls in plain torch run in IEEE
fp32: TF32 is switched off for both matmul and cuDNN.
"""

from __future__ import annotations

import gc
import json
import mmap
import os
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
CHAIN_DRIFT_LAUNCHES = 25   # kernel 7's "high" chain: 25 launches of P = 8
MM_ROW_BITS = ((0, 1), (0,))   # the mxu "high" mm step's checks: D = 512
                               # (kh = 2, 574 of mxu's 582 mm steps at n=24)
                               # and D = 256 (kh = 1)
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
MM_SRC = "gpu_quantum_simulator_tpu_torch/csrc/mm_high.cu"
MM_TPU = "gpu_quantum_simulator_tpu/engine/wide.py:184"   # an XLA dot there
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
TWO_STREAM_STEPS = 8        # in-place "high" steps on each of two streams
INPLACE_WIDTHS = (18, 22, 23)   # in-place path held to the f64 reference
INPLACE_SMALL = range(9, 18)    # in place below the first cross-tile swap
RESUME_AT = 1200            # gate after which a run resumes from its state
FULL_WIDTH = 30             # the width where prefetch runs in place unasked
FULL_PEAK_SLACK = 2 << 30   # peak device memory allowed above the state
FULL_NORM_TOL = 1e-5        # n=30 norm_halves after its 692 "high" steps
SAMPLES = 200_000
SAMPLE_BINS = 4096
HALVES_TOL = 1e-5           # n=30 halves routes vs the flat routes
HALVES_QUBITS = ([0], [7], [-1], [3, 7, 20], [-2, 7, 1, 15])  # -k: n - k
# phase 7, the facade's program entry points
GROVER_DATA = 13            # grover_parts(13): 13 data + 11 ancillas, n=24
GROVER_MARKED = 5301        # the marked data state (< 2^13)
ENTRY_STRATEGIES = ("mxu", "prefetch")
ENTRY_RUNGS = ("auto", "highest")   # "auto" is "high" at n=24
GROVER_DEPTHS = (18, 36)    # repetitions besides the natural 71: the
                            # rungs' error against depth
TROTTER = (28, 0.05, 20)    # trotter_tfim_parts(n, dt, steps=...) on mxu
TROTTER_TOL = 1e-4          # <H> on the iterated state (mxu) vs the
                            # "basis" method (prefetch), "highest": two
                            # engines' states, each ~1e-6 off norm after
                            # 600 ops, times |<H>| = 27 (the float64 sums
                            # part from the fp32 ones by 1.5e-5 only)
GRAPH_MEMORY = (28, 4, 3)   # (n, distinct qaoa bodies, repetitions each)
GRAPH_MEMORY_SLACK = 2 << 30  # one n=28 state pair: a second live graph
                              # would add two (its static and spare pairs)
PARTS_WIDTH = 24            # run_device_parts: two halves of a circuit
PARTS_GATES = 800
GRAPH_TIMED = 10            # graph replays timed per (strategy, rung)
BENCH_OPS = 600             # fused ops of grover_like(24, 2445, 318), the
                            # depth PERF.md section 2's bars were set at
                            # (582-626 by strategy)
MANY = (24, 8)              # run_many: 8 qaoa_maxcut candidates at n=24
MANY_TOL = 1e-5             # run_many(terms=) vs expectation_pauli_sum
# phase 8, the CLI and the per-gate strategies
CLI_WIDTH = 24              # the default config through the CLI ("high")
CLI_FLAT = 22               # --strategy prefetch --precision highest
CLI_INPLACE = (24, 1200)    # --inplace at n=24, resumed after this gate
ABLATION_WIDTH = 18         # the reference's ablation rows (BASELINE.md)
ABLATION_STRATEGIES = ("naive", "fused2x2", "fused3in1", "fused4x4", "scan",
                       "megakernel", "mxu", "prefetch")
PER_GATE_TOL = 5e-6         # the per-gate engines' bar against f64 (f32
                            # rounding after every one of 2445 gates;
                            # tests/test_engines.py), mxu and prefetch 1e-6
ABLATION_RUNS = 3           # timed CLI runs after one warm-up
SYNC_CHECKED = ("naive", "scan")   # dispatched under sync debug "error"
# the redesigned kernels' previous designs, each read twice in one call of
# chip_ab.py beside the current ones (H100 80GB HBM3 at 700 W; PERF.md
# section 6): printed beside this run's times
BEFORE_MS = {"fp32 mat step n=22": "0.1941-0.1951",
             "fp32 mat step n=24 (flat)": "0.7439-0.7481",
             "vmem chunk n=18": "3.2107-3.2258",
             "vmem one D=512 op n=18": "0.0329-0.0331",
             "high mat step n=24 (flat)": "0.6867",
             "high mat step n=28 (flat)": "10.5654",
             "high mat step n=24 (in place)": "0.6671",
             "high mat step n=30 (in place)": "41.26-41.27",
             "mm step n=24 D=512": "1.4342",
             "mm step n=24 D=256": "0.7629-0.7694",
             "chain n=24 P=8 high": "2.2199-2.2200",
             "chain n=24 P=1 high": "0.3543-0.3560",
             # the "default" arms as the "high" bodies' second
             # instantiations, before their own k-loops (PERF.md
             # section 6)
             "default mat step n=24 (flat)": "0.3262",
             "default mat step n=28 (flat)": "4.8701",
             "default mat step n=24 (in place)": "0.4028",
             "default mat step n=30 (in place)": "22.2428",
             "default mm step n=24 D=512": "0.6119",
             "default mm step n=24 D=256": "0.2709",
             # kernel 7's "default" chain before its body of its own
             "default chain n=24 P=1": "0.1577-0.1579",
             "default chain n=24 P=8": "0.8786-0.8795"}


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


def sass_kloop(part, per_chunk, chunks=1):
    """(instructions, HGMMA, F2FP, FADD, LDS) a k-chunk of one function's
    k-loop (F2FP: the bf16 packs of the splits): the shortest loop that
    holds ``chunks`` k-chunks' HGMMA (``per_chunk`` a chunk; the "default"
    mat and mm steps unroll their k-loops in runs of DEFAULT_RUN chunks),
    its counts over ``chunks``.  The counts are the loop's code, branches
    not taken included."""
    import re

    code = []
    for a, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*);", part):
        words = text.split()
        op = words[1] if words and words[0].startswith("@") else (
            words[0] if words else "")
        code.append((int(a, 16), op, text))
    wgmma = [a for a, op, _ in code if op.startswith("HGMMA")]
    best = None
    for b, op, text in code:
        m = re.search(r"\bBRA\b[^0-9]*?(0x[0-9a-f]+)", text)
        if not (op.startswith("BRA") and m):
            continue
        t = int(m.group(1), 16)
        if t < b and sum(t <= a <= b for a in wgmma) == per_chunk * chunks \
                and (best is None or b - t < best[1] - best[0]):
            best = (t, b)
    if best is None:
        return None
    body = [op for a, op, _ in code if best[0] <= a <= best[1]]
    return tuple(round(x / chunks, 1) for x in (
        (len(body),) + tuple(sum(op.startswith(k) for op in body)
                             for k in ("HGMMA", "F2FP", "FADD", "LDS"))))


DEFAULT_RUN = 4             # k-chunks a run of the "default" mat and mm
                            # steps' unrolled k-loops (KRUN in
                            # csrc/wgmma_high.cuh and csrc/mm_high.cu)
CHAIN_DEFAULT_UNROLL = 2    # k-chunks an iteration of the "default"
                            # chain's k-loop (csrc/wide_chain.cu)
BF16_KERNEL = (r"\d(mat_high_kernel|mat_high_halves_kernel|mm_high_kernel|"
               r"chain_high_kernel)I(?:Li(\d+)E)?Lb([01])E")


def bf16_kernel_key(name):
    """'mat_high_kernel<default>' and the like for a mangled name of one of
    the bf16 kernels' instantiations, else None."""
    import re

    m = re.search(BF16_KERNEL, name)
    if not m:
        return None
    rung = "high" if m.group(3) == "1" else "default"
    return (m.group(1) + "<" + (f"{m.group(2)}, " if m.group(2) else "")
            + rung + ">")


def ptxas_usage(log):
    """{kernel key: (registers, spill stores, spill loads)} of the bf16
    kernels from the build's ``-Xptxas -v`` log."""
    import re

    usage, key, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            key = bf16_kernel_key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            usage[key] = (int(m.group(1)),) + spills
            key, spills = None, (0, 0)
    return usage


def check_high_sass():
    """The bf16 kernels that run on wgmma, each at both of its rungs (the
    "high" and "default" instantiations of one kernel): the two mat-step
    kernels (flat and in place) hold HGMMA and none of their previous
    design's tf32 mma.sync k4 (HMMA.1684.F32.TF32); every instantiation of
    the mxu mm step (mm_high_kernel, one per D) and the chain kernel's bf16
    arm (chain_high_kernel) hold HGMMA and no mma.sync HMMA at all (their
    previous designs' bf16 m16n8k16 and tf32 k4 passes).  It prints the
    k-loop's instruction mix (a k-chunk an iteration, averaged over the
    chunks of an iteration in the "default" k-loops; the chain splits or
    rounds its rows once per product, outside the loop) with the registers
    and spills ptxas reported, for every "default" kernel, both "high"
    mat-step kernels and the "high" chain and D = 128 mm step, which share
    their k-chunk body."""
    import os
    import re

    from gpu_quantum_simulator_tpu_torch.kernels import build

    counts, loops = {}, {}
    for part in build.dump_sass().split("Function : ")[1:]:
        key = bf16_kernel_key(part.split("\n", 1)[0])
        if key:
            counts[key] = (part.count("HGMMA"),
                           part.count("HMMA.1684.F32.TF32"),
                           len(re.findall(r"\bHMMA\.", part)))
            kernel, high = key.split("<")[0], key.endswith("high>")
            per_chunk = {"mat_high_kernel": 16, "mat_high_halves_kernel": 16,
                         "mm_high_kernel": 12, "chain_high_kernel": 12}[
                kernel] // (1 if high else 2)
            chunks = (1 if high else CHAIN_DEFAULT_UNROLL
                      if kernel == "chain_high_kernel" else DEFAULT_RUN)
            loops[key] = sass_kloop(part, per_chunk, chunks)
    want = [k for rung in ("high", "default") for k in (
        [f"mat_high_kernel<{rung}>", f"mat_high_halves_kernel<{rung}>",
         f"chain_high_kernel<{rung}>"]
        + [f"mm_high_kernel<{d}, {rung}>" for d in (128, 256, 512)])]
    for kernel in want:
        hgmma, tf32, hmma = counts.get(kernel, (0, 0, 0))
        print(f"sass {kernel}: {hgmma} HGMMA, {tf32} HMMA.1684.F32.TF32, "
              f"{hmma} HMMA in all")
        old = hmma if kernel.startswith(("mm_", "chain_")) else tf32
        if kernel not in counts or hgmma == 0 or old != 0:
            raise AssertionError(f"{kernel}: not the wgmma kernel "
                                 f"({hgmma} HGMMA, {hmma} HMMA)")
    log_path = os.path.join(build.BUILD_DIR, "build.log")
    usage = ptxas_usage(open(log_path).read()) if os.path.exists(
        log_path) else {}
    shown = ["mat_high_kernel<high>", "mat_high_halves_kernel<high>",
             "chain_high_kernel<high>", "mm_high_kernel<128, high>"] + [
        k for k in want if k.endswith("default>")]
    for kernel in shown:
        regs = usage.get(kernel)
        regs = ("registers not in the build log" if regs is None else
                f"{regs[0]} registers, spill stores {regs[1]} B, loads "
                f"{regs[2]} B")
        if loops.get(kernel):
            n, hg, f2fp, fadd, lds = loops[kernel]
            print(f"sass {kernel} k-loop: {n} instructions a k-chunk and "
                  f"thread, {hg} HGMMA, {f2fp} F2FP (bf16 splits), {fadd} "
                  f"FADD, {lds} LDS; {regs}")
        else:
            print(f"sass {kernel}: no k-loop found; {regs}")


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
          f"TFLOP/s; previous design "
          f"{BEFORE_MS['fp32 mat step n=22']} ms), plain {plain_ms:.4f} ms "
          f"({flop / plain_ms / 1e9:.2f} TFLOP/s), fp32 torch.matmul "
          f"{library_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), max|diff| "
          f"{e:.3e}")
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
    # the card's measured copy rate at this width: copy_ of the same pair
    dst = torch.empty_like(pair)
    copy_ms = device_ms(torch, lambda: dst.copy_(pair))
    rate = 8.0 * pair.numel() / (copy_ms * 1e-3)      # bytes read + written
    gbs = 4 * re.numel() * 4 / (ms * 1e-3) / 1e9
    bnd = bound(0.0, 16.0 * re.numel())
    print(f"relayout kernel n={n} sigma={sigma.tolist()}: bit-exact; kernel "
          f"{ms:.4f} ms ({gbs:.0f} GB/s), plain {plain_ms:.4f} ms, "
          f"permute-copy {library_ms:.4f} ms, bound {bnd[0]:.4f} ms; copy_ "
          f"of the pair {copy_ms:.4f} ms ({rate / 1e9:.1f} GB/s), the bytes "
          f"at that rate {16.0 * re.numel() / rate * 1e3:.4f} ms")
    del dst
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
    high = split_tables(a_tab, b_tab)
    rec = None
    for n, reps in HIGH_STEPS:
        R2 = 1 << (n - PF.LOCAL_QUBITS)
        logt = int(np.log2(PF.tile_rows(n)))
        re = torch.randn(R2, 256, device="cuda")
        im = torch.randn(R2, 256, device="cuda")
        args = (a_tab[0], b_tab[0], mono_src[0], logt, PF.CAP_STEPS)
        scratch = (torch.empty_like(re), torch.empty_like(im))
        got = run_block(scal[0], re.clone(), im.clone(), *args,
                        scratch=scratch, precision="high",
                        high_tables=high[0])
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
            high_tables=high[0]), reps=reps)
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
              f" bf16 TFLOP/s; previous design "
              f"{BEFORE_MS[f'high mat step n={n} (flat)']} ms), plain "
              f"{plain_ms:.4f} ms, fp32 kernel "
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


def random_state(torch, gen, shape):
    """A normalised random (re, im) pair of ``shape`` from ``gen``."""
    re, im = (torch.randn(*shape, device="cuda", generator=gen)
              for _ in range(2))
    scale = norm2((re, im)) ** -0.5
    return re * scale, im * scale


def drift_seed(what, seed, drift, n0, steps):
    """Print one seed's drift series; return its (kernel, plain) last pair."""
    for k, v in drift.items():
        print(f"{what} seed {seed} {k}: |out|^2/|in|^2 - 1 after {steps}: "
              + json.dumps([float(f"{x:.3g}") for x in v]))
    k, p = drift["kernel"][-1], drift["plain"][-1]
    print(f"{what} seed {seed}: |1 - norm| at the end kernel {abs(k):.4e}, "
          f"plain {abs(p):.4e} (ratio {abs(k / p):.3f}); the kernel's beyond "
          f"the plain's {k - p:.4e}; the state's norm at the start "
          f"{n0:.10f}")
    return k, p


def drift_verdict(what, last, barred=True, own=None):
    """Over the seeds: the largest kernel |1 - norm| against DRIFT_RATIO x
    the largest plain one, and every seed's kernel drift within
    DRIFT_EXCESS of the plain one's (``own``: per seed, the kernel's drift
    beyond the plain version's summed step by step on the kernel's chain,
    in place of the two chains' difference); raises when ``barred`` and
    either fails."""
    worst_k = max(abs(k) for k, _ in last.values())
    worst_p = max(abs(p) for _, p in last.values())
    excess = max(abs(x) for x in (own.values() if own else
                                  (k - p for k, p in last.values())))
    print(f"{what} over seeds {list(last)}: largest |1 - norm| kernel "
          f"{worst_k:.4e}, plain {worst_p:.4e} (ratio {worst_k / worst_p:.3f}"
          f", bar {DRIFT_RATIO}); largest |kernel - plain| "
          f"{'step by step ' if own else ''}{excess:.4e} (bar "
          f"{DRIFT_EXCESS}){'' if barred else ' -- not barred'}; per-seed "
          f"ratios " + json.dumps(
              {s: round(abs(k / p), 3) for s, (k, p) in last.items()}))
    if barred and not (worst_k <= DRIFT_RATIO * worst_p
                       and excess <= DRIFT_EXCESS):
        raise AssertionError(f"{what}: kernel {worst_k} against "
                             f"{DRIFT_RATIO} x plain {worst_p}; beyond the "
                             f"plain {excess} against {DRIFT_EXCESS}")


def check_high_drift(torch, precision="high"):
    """200 chained "high" (or ``precision``) mat steps at n=24 on a
    normalised random state,
    the tables eight random 256 x 256 unitaries taken in turn (a block
    entry's eight slots): the norm's drift after every step, kernel and
    plain version each on its own chain, for every seed of DRIFT_SEEDS (a
    state and tables each).  A unitary keeps the norm; what remains is the
    rung's rounding, and in the kernel the tensor core's truncating adds
    (csrc/wgmma_high.cuh).  Its draws have seeds of their own, so the phases after
    it draw as they did without it.

    At "default" the two chains part: one bf16 pass is discontinuous, an
    ulp of difference in a step's input moves a value's rounding by 2^-9,
    and after a few steps the chains' norms drift apart by tens of 1e-6
    (3.4e-5 on an H100) while each drifts ~1.6e-3.  So there the kernel's
    drift beyond the plain version is summed step by step, each kernel
    step against the plain step on the same input (the kernel's chain);
    the ratio bar still compares the two chains."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, run_block_plain, split_tables)

    n, cap = DRIFT_WIDTH, PF.CAP_STEPS
    R2 = 1 << (n - PF.LOCAL_QUBITS)
    logt = int(np.log2(PF.tile_rows(n)))
    mono = torch.zeros(DRIFT_SLOTS, 256, dtype=torch.int32, device="cuda")

    def row(j):           # one mat step on slot j
        return [1, 0, 0, 0] + [0] * cap + [j] + [0] * (cap - 1)

    last, own = {}, {}
    stepwise = precision == "default"
    for seed in DRIFT_SEEDS:
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        mats = [random_unitary(rng, 256) for _ in range(DRIFT_SLOTS)]
        a_tab = torch.tensor(np.stack([m.real.T for m in mats]),
                             dtype=torch.float32, device="cuda").contiguous()
        b_tab = torch.tensor(np.stack([m.imag.T for m in mats]),
                             dtype=torch.float32, device="cuda").contiguous()
        high = split_tables(a_tab, b_tab)
        start = random_state(torch, gen, (R2, 256))
        n0 = norm2(start)
        kern = (start[0].clone(), start[1].clone())
        spare = (torch.empty_like(kern[0]), torch.empty_like(kern[1]))
        plain = start
        drift = {"kernel": [], "plain": []}
        own[seed] = 0.0
        for step in range(DRIFT_STEPS):
            j = step % DRIFT_SLOTS
            if stepwise:
                same_in = norm2(run_block_plain(
                    row(j), *kern, a_tab, b_tab, mono, logt, cap,
                    precision=precision))
            out = run_block(row(j), *kern, a_tab, b_tab, mono, logt, cap,
                            scratch=spare, precision=precision,
                            high_tables=high)
            spare, kern = kern, out
            if stepwise:
                own[seed] += (norm2(kern) - same_in) / n0
            plain = run_block_plain(row(j), *plain, a_tab, b_tab, mono, logt,
                                    cap, precision=precision)
            drift["kernel"].append(norm2(kern) / n0 - 1.0)
            drift["plain"].append(norm2(plain) / n0 - 1.0)
        last[seed] = drift_seed(f"{precision} drift n={n}", seed, drift, n0,
                                f"steps 1..{DRIFT_STEPS}")
        if stepwise:
            print(f"{precision} drift n={n} seed {seed}: the kernel's beyond "
                  f"the plain's, step by step on the kernel's chain "
                  f"{own[seed]:.4e}")
        del kern, spare, plain, start, out, a_tab, b_tab, high
        torch.cuda.empty_cache()
    drift_verdict(f"{precision} drift n={n}, {DRIFT_STEPS} steps", last,
                  own=own if stepwise else None)


def check_chain_drift(torch):
    """Kernel 7's "high" chain, the same measurement: at n=24 a normalised
    random (R, 128) state through CHAIN_DRIFT_LAUNCHES launches of
    ``kh0_chain(..., "high")`` with P = KH0_BATCH random 128 x 128
    unitaries (200 products; their Karatsuba tables ``kh0_high_tables``,
    the kernel's 8-term hi.hi partials), kernel and plain version
    (``karatsuba_high``, every bf16 product summed in IEEE fp32) each on
    its own chain, for every seed of DRIFT_SEEDS; held to the same
    bars."""
    from gpu_quantum_simulator_tpu_torch.engine.wide import KH0_BATCH
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW

    n = WIDE_WIDTH
    R = 1 << (n - 7)
    last = {}
    for seed in DRIFT_SEEDS:
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        us = [random_unitary(rng, 128) for _ in range(KH0_BATCH)]
        tabs = torch.tensor(np.stack([np.stack([u.real, u.imag]) for u in us]),
                            dtype=torch.float32, device="cuda")
        w16 = KW.kh0_high_tables(tabs)
        start = random_state(torch, gen, (R, 128))
        n0 = norm2(start)
        kern = (start[0].clone(), start[1].clone())
        plain = start
        drift = {"kernel": [], "plain": []}
        for _ in range(CHAIN_DRIFT_LAUNCHES):
            KW.kh0_chain(*kern, tabs, "high", out=kern, w16=w16)
            plain = KW.kh0_chain_plain(*plain, tabs, "high", w16=w16)
            drift["kernel"].append(norm2(kern) / n0 - 1.0)
            drift["plain"].append(norm2(plain) / n0 - 1.0)
        last[seed] = drift_seed(
            f"chain high drift n={n} P={KH0_BATCH}", seed, drift, n0,
            f"launches 1..{CHAIN_DRIFT_LAUNCHES}")
        del kern, plain, start, tabs, w16
        torch.cuda.empty_cache()
    drift_verdict(f"chain high drift n={n}, "
                  f"{CHAIN_DRIFT_LAUNCHES * KH0_BATCH} products", last)


def mm_unitary_tables(torch, rng, D, count):
    """``count`` random D x D unitaries as the mxu engine's float32
    Karatsuba tables (count, 3, D, D): m1 = M_re^T, m2 = (M_im - M_re)^T,
    m3 = (M_re + M_im)^T."""
    us = [random_unitary(rng, D) for _ in range(count)]
    return torch.tensor(np.stack([np.stack([u.real.T, (u.imag - u.real).T,
                                            (u.real + u.imag).T])
                                  for u in us]),
                        dtype=torch.float32, device="cuda")


def cublas_trio(torch, bf16_split):
    """The mxu "high" mm step as the port ran it before its kernel, the
    yardstick beside it: three real products, each three cuBLAS bf16 GEMMs
    with fp32 output, on the (hi, lo) bfloat16 tables [k][n]."""
    def dot(x, mh, ml):
        xh = x.to(torch.bfloat16)
        xl = (x - xh.float()).to(torch.bfloat16)
        out = torch.mm(xh, mh, out_dtype=torch.float32)
        out += torch.mm(xl, mh, out_dtype=torch.float32)
        out += torch.mm(xh, ml, out_dtype=torch.float32)
        return out

    def step(xr, xi, hi, lo):
        t1 = dot(xr + xi, hi[0], lo[0])
        t2 = dot(xr, hi[1], lo[1])
        t3 = dot(xi, hi[2], lo[2])
        return t1 - t3, t1 + t2

    return step


def check_mm_high(torch):
    """The mxu engine's "high" mm step (csrc/mm_high.cu) at n=24 on a
    normalized (R, 128) state, read and written through the row map of a
    D = 512 (row bits 0, 1) and a D = 256 (row bit 0) block: against its
    plain version (<= CHAIN_TOL; the plain version without the xh.m1_lo
    correction must miss that bar), timed beside its bound, the plain
    version and the cuBLAS GEMMs it replaced, with and without the row
    shuffles around them (no single PyTorch call computes the 3-pass
    product).  The record is D = 512's, the main path's shape.  Its draws
    have seeds of their own, so the phases after it draw as they did
    without it."""
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW
    from gpu_quantum_simulator_tpu_torch.kernels.block import bf16_split

    n = WIDE_WIDTH
    R = 1 << (n - 7)
    gen = torch.Generator(device="cuda").manual_seed(n)
    rng = np.random.default_rng(n)
    re, im = random_state(torch, gen, (R, 128))
    trio = cublas_trio(torch, bf16_split)
    rec, err = None, 0.0
    for row_bits in MM_ROW_BITS:
        D = 128 << len(row_bits)
        M = (1 << n) // D
        fwd, bwd = KW.row_shuffles(row_bits, R)
        m32 = mm_unitary_tables(torch, rng, D, 1)[0]
        w16 = KW.split_mm_tables(m32)
        got = KW.mm_step_high(re, im, w16, row_bits)
        want = KW.mm_step_high_plain(re, im, w16, row_bits)
        tabs = KW.mm_tables_f32(w16)
        tabs[1] = torch.zeros_like(tabs[1])
        dropped = tuple(bwd(x) for x in KW.karatsuba_high(fwd(re), fwd(im),
                                                          tabs))
        hi, lo = (p.to(torch.bfloat16) for p in bf16_split(m32))

        def old_step():          # shuffles around the cuBLAS GEMMs
            t1, t2 = trio(fwd(re), fwd(im), hi, lo)
            return bwd(t1), bwd(t2)

        old = old_step()
        torch.cuda.synchronize()
        e, e_drop, e_old = (max_diff(got, x) for x in (want, dropped, old))
        if not e <= CHAIN_TOL:
            raise AssertionError(f"mm step D={D}: {e} > {CHAIN_TOL}")
        if not e_drop > CHAIN_TOL:
            raise AssertionError(f"mm step D={D}: a dropped correction "
                                 f"passes ({e_drop})")
        err = max(err, e)
        del want, dropped, tabs, old
        out = (torch.empty_like(re), torch.empty_like(im))
        ms = device_ms(torch, lambda: KW.mm_step_high(re, im, w16, row_bits,
                                                      out=out), reps=10)
        plain_ms = device_ms(torch, lambda: KW.mm_step_high_plain(
            re, im, w16, row_bits), reps=3)
        xr, xi = fwd(re), fwd(im)
        trio_ms = device_ms(torch, lambda: trio(xr, xi, hi, lo), reps=10)
        del xr, xi
        old_ms = device_ms(torch, old_step, reps=10)
        flop = 9 * 2.0 * M * D * D      # three real products, 3 passes each
        bnd = bound(flop, 16.0 * M * D + 6 * D * D * 2, BF16_FLOPS)
        before = BEFORE_MS.get(f"mm step n={n} D={D}")
        print(f"mm step high n={n} D={D} row bits {row_bits}: max|diff| vs "
              f"plain {e:.3e}, without xh.m1_lo {e_drop:.3e}, vs the cuBLAS "
              f"bf16 GEMMs {e_old:.3e}; kernel {ms:.4f} ms "
              f"({flop / ms / 1e9:.1f} bf16 TFLOP/s of useful work"
              + (f"; previous design {before} ms + the row shuffles"
                 if before else "") + f"), plain {plain_ms:.4f} ms, cuBLAS "
              f"bf16 GEMMs (9 torch.mm + elementwise) {trio_ms:.4f} ms, with "
              f"the row shuffles {old_ms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
        if rec is None:
            rec = record("mm_step_high", MM_SRC, MM_TPU, e, ms, plain_ms,
                         bnd, None)
        del got, out, hi, lo, w16, m32
    rec["max_abs_err"] = err
    del re, im
    torch.cuda.empty_cache()
    return rec


def mxu_high_drift(torch):
    """The mxu engine's "high" mm step, the drift measurement with its
    bars: ``engine/wide.py`` ``_mm_step`` (the kernel csrc/mm_high.cu,
    through the row map into a spare pair) at n=24 on a D = 512 block
    (row bits 0, 1) and a D = 256 block (row bit 0), DRIFT_STEPS steps
    over DRIFT_SLOTS random unitaries taken in turn, for every seed of
    DRIFT_SEEDS; beside it the plain version (``karatsuba_high``, every
    bf16 product summed in IEEE fp32) and the "highest" step (fp32 GEMMs).
    Held to DRIFT_RATIO and DRIFT_EXCESS at each D."""
    from gpu_quantum_simulator_tpu_torch.engine import wide as TW
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW

    n = WIDE_WIDTH
    R = 1 << (n - 7)
    for row_bits in MM_ROW_BITS:
        D = 128 << len(row_bits)
        fwd, bwd = KW.row_shuffles(row_bits, R)
        last = {}
        for seed in DRIFT_SEEDS:
            rng = np.random.default_rng(seed)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            m32 = mm_unitary_tables(torch, rng, D, DRIFT_SLOTS)
            w16 = KW.split_mm_tables(m32)
            tabs = [KW.mm_tables_f32(w16[j]) for j in range(DRIFT_SLOTS)]
            start = random_state(torch, gen, (R, 128))
            n0 = norm2(start)
            chains = {k: list(start) for k in ("kernel", "plain", "fp32")}
            spare: list = []
            drift = {k: [] for k in chains}
            for step in range(DRIFT_STEPS):
                j = step % DRIFT_SLOTS
                TW._mm_step(chains["kernel"], spare, w16[j], row_bits, R,
                            "high")
                out = KW.karatsuba_high(*(fwd(x) for x in chains["plain"]),
                                        tabs[j])
                chains["plain"] = [bwd(x) for x in out]
                TW._mm_step(chains["fp32"], [], m32[j], row_bits, R,
                            "highest")
                for k, v in chains.items():
                    drift[k].append(norm2(v) / n0 - 1.0)
            print(f"mxu high drift n={n} D={D} seed {seed}: fp32 step "
                  f"|out|^2/|in|^2 - 1 after {DRIFT_STEPS} steps "
                  f"{drift.pop('fp32')[-1]:.4e}")
            last[seed] = drift_seed(f"mxu high drift n={n} D={D}", seed,
                                    drift, n0, f"steps 1..{DRIFT_STEPS}")
            del chains, spare, start, m32, w16, tabs, out
            torch.cuda.empty_cache()
        drift_verdict(f"mxu high drift n={n} D={D}, {DRIFT_STEPS} steps",
                      last)


def check_wide_chain(torch, rng):
    """The lane-layout chain kernel at n=24 on a normalized state: P = 1
    and 8 products at both rungs (kernel 7), in place and out of place,
    and one product as ``apply_block128`` (kernel 9).  At "high" a chain
    of one product is the D = 128 mm step (csrc/mm_high.cu, the same
    k-chunk body and tables) bit for bit.  Library call: P complex64
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
            w16 = KW.kh0_high_tables(tabs) if prec == "high" else None
            got = KW.kh0_chain(re, im, tabs, prec, w16=w16)
            want = KW.kh0_chain_plain(re, im, tabs, prec, w16=w16)
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
            mm = ""
            if prec == "high" and P == 1:
                step = KW.mm_step_high(re, im, w16[0], ())
                same = bool(torch.equal(step[0], got[0])
                            and torch.equal(step[1], got[1]))
                mm = (f"; vs the D = 128 mm step max|diff| "
                      f"{max_diff(got, step):.3e} (bit for bit: {same})")
                if not same:
                    raise AssertionError("chain P=1 high: not the D = 128 "
                                         "mm step bit for bit")
                del step
            out = (torch.empty_like(re), torch.empty_like(im))
            ms = device_ms(torch, lambda: KW.kh0_chain(
                re, im, tabs, prec, out=out, w16=w16), reps=10)
            plain_ms = device_ms(torch, lambda: KW.kh0_chain_plain(
                re, im, tabs, prec, w16=w16), reps=5)
            flop = 6.0 * R * 128 * 128 * P      # three real products each
            nbytes = 16.0 * R * 128
            if prec == "high":          # six bf16 tables a product
                bnd = bound(3 * flop, nbytes + P * 6 * 128 * 128 * 2,
                            BF16_FLOPS)
            else:
                bnd = bound(flop, nbytes + P * 2 * 128 * 128 * 4)
            before = BEFORE_MS.get(f"chain n={n} P={P} {prec}")
            print(f"chain kernel n={n} P={P} {prec}: max|diff| vs plain "
                  f"{e:.3e}, vs complex64 matmul {e_lib:.3e}{mm}; in place "
                  f"bit-exact; kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} "
                  f"TFLOP/s, Karatsuba count"
                  + (f"; previous design {before} ms" if before else "")
                  + f"), plain {plain_ms:.4f} ms, "
                  f"complex64 torch.matmul x{P} {library_ms:.4f} ms "
                  f"({flop / library_ms / 1e9:.1f}), bound {bnd[0]:.4f} ms "
                  f"({bnd[1]})")
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
            flop = 6.0 * R * 128 * 128
            print(f"apply_block128 n={n}: max|diff| vs plain {e:.3e}; kernel "
                  f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, Karatsuba "
                  f"count), plain {plain_ms:.4f} ms, complex64 torch.matmul "
                  f"{library_ms:.4f} ms ({flop / library_ms / 1e9:.1f}), "
                  f"bound {bnd[0]:.4f} ms ({bnd[1]})")
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
          f"{flop / ms / 1e9:.1f} TFLOP/s as Karatsuba; previous design "
          f"{BEFORE_MS['vmem chunk n=18']} ms), plain "
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
          f"(previous design {BEFORE_MS['vmem one D=512 op n=18']} ms; the "
          f"chunk's per-op share {ms / len(by_d):.4f} ms), plain "
          f"{plain1:.4f} ms, complex64 torch.matmul on the shuffled state "
          f"{library_ms:.4f} ms, bound {bnd1[0]:.4f} ms ({bnd1[1]})")
    op = record("vmem_chunk_one_op", VMEM_SRC, VMEM_TPU, e1, ms1, plain1,
                bnd1, library_ms)
    return chunk, op


# the smoke's short names of the port's launch counters (telemetry's
# ``launches/<wrapper>[/<kind>]``); the block kernels' kinds keep their own
# names, the in-place block kernel's take "split_"
SHORT_NAMES = {"run_relayout": "relayout", "kh0_chain/highest": "kh0",
               "kh0_chain/high": "kh0_high",
               "kh0_chain/default": "kh0_default",
               "apply_block128": "block128", "mm_step_high": "mm_high",
               "mm_step_default": "mm_default", "vmem_chunk": "vmem",
               "run_xswap": "xswap",
               "run_relayout_inplace": "relayout_inplace",
               "apply_butterfly_high": "butterfly",
               "grid_copy": "copy_grid", "stream_copy": "copy_stream",
               "hbm_direct": "copy_direct"}


def launch_counts():
    """Every launch counter of the port (``telemetry.counters``), by the
    smoke's short names."""
    from gpu_quantum_simulator_tpu_torch import telemetry
    # every counting wrapper registers itself when its module loads
    from gpu_quantum_simulator_tpu_torch.kernels import (  # noqa: F401
        block, copy, relayout, split, vmem, wide)
    from gpu_quantum_simulator_tpu_torch.ops import (  # noqa: F401
        pallas_kernels)
    from gpu_quantum_simulator_tpu_torch.parallel import (  # noqa: F401
        sharded_prefetch)

    out = {}
    for key, v in telemetry.counters().items():
        if not key.startswith("launches/"):
            continue
        name = key[len("launches/"):]
        wrapper, _, kind = name.partition("/")
        out[kind if wrapper == "run_block"
            else "split_" + kind if wrapper == "run_split_block"
            else SHORT_NAMES.get(name, name)] = v
    return out


def reset_counts():
    from gpu_quantum_simulator_tpu_torch import telemetry

    telemetry.reset()


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


def check_counts(n, counts, modes, runs, high, default=False):
    """Launch counts of ``runs`` runs of one program against its plan;
    ``high`` / ``default``: the run was at the "high" / "default" rung."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF

    block = (counts["mat"] + counts["mat_high"] + counts["mat_default"]
             + counts["gather"] + counts["folded"])
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
    if default != (counts["mat_default"] > 0):
        raise AssertionError(f"n={n}: 'default' mat launches "
                             f"{counts['mat_default']} at default={default}")


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

    def mm_steps(prog):
        return sum(st[0] == "mm" for seg in prog.segments for st in seg.steps)

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
    # every mm step one launch of the "high" mm kernel (no cuBLAS GEMM)
    check_only(n, counts, runs, kh0_high=prog.num_kh0_runs,
               mm_high=mm_steps(prog))
    ref, ref_secs, ref_counts = drive_engine(
        torch, mxu(precision="highest"), c, 0, S._MXU_PLAN_CACHE)
    add(ref_counts)
    err = float(np.max(np.abs(res.state - ref.state)))
    e_pf = float(np.max(np.abs(ref.state - highest24)))
    norm = float(np.linalg.norm(res.state))
    report(n, res, secs, counts, f"mxu 'high'; vs its 'highest' run "
           f"{err:.3e} ('highest' run {ref_secs[0]:.4f} s); 'highest' vs "
           f"prefetch 'highest' {e_pf:.3e}; norm {norm:.8f}; kh0 runs {ps}; "
           f"mm steps {mm_steps(prog)}")
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
            check_only(n, counts, 2, **{kh0[prec]: prog.num_kh0_runs},
                       mm_high=mm_steps(prog) if prec == "high" else 0)
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
    high = split_tables(a_tab, b_tab)
    h = random_halves(torch, n)
    tols = {"highest": SPLIT_MAT_TOL, "high": BLOCK_TOL}
    err = {}
    for i, name in enumerate(("every step kind", "index steps only")):
        for rung in ("highest", "high")[: 2 - i]:
            args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
            got = run_split_block(scal[i], clone4(h), *args, precision=rung,
                                  high_tables=high[i])
            want = run_split_block_plain(scal[i], clone4(h), *args,
                                         precision=rung)
            flat = run_block(scal[i], *joined(torch, h), *args,
                             precision=rung, high_tables=high[i])
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
                              high_tables=high[i])
        want = run_split_block_plain(scal[i], clone4(h), *args,
                                     precision=rung)
        miss = run_split_block_plain(scal[i], clone4(h), *dropped,
                                     precision=rung)
        # the flat step (kernel 1) on the joined state: the same sums in
        # the same order at "highest", so bit for bit
        flat = run_block(scal[i], *joined(torch, h), *args, precision=rung,
                         high_tables=high[i])
        torch.cuda.synchronize()
        e, e_drop = diff4(got, want), diff4(got, miss)
        e_flat = max_diff(joined(torch, got), flat)
        # both rungs: one kernel body, the same sums in the same order
        print(f"split mat step n={n} {rung}: in place vs the flat step "
              f"max|diff| {e_flat:.3e} (bar 0.0)")
        if e_flat != 0.0:
            raise AssertionError(f"split mat step {rung}: flat and in place "
                                 f"differ ({e_flat})")
        if not e <= tols[rung]:
            raise AssertionError(f"split mat step {rung}: {e} > {tols[rung]}")
        if not e_drop > tols[rung]:
            raise AssertionError(f"split mat step {rung}: dropped products "
                                 f"pass ({e_drop})")
        del want, miss, flat
        reps = 10
        ms = device_ms(torch, lambda: run_split_block(
            scal[i], h, *args, precision=rung, high_tables=high[i]),
            reps=reps)
        plain_ms = device_ms(torch, lambda: run_split_block_plain(
            scal[i], h, *args, precision=rung), reps=3)
        pair = joined(torch, h)
        scratch = (torch.empty_like(pair[0]), torch.empty_like(pair[1]))
        flat_ms = device_ms(torch, lambda: run_block(
            scal[i], *pair, *args, scratch=scratch, precision=rung,
            high_tables=high[i]), reps=reps)
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
        tf = 1e-9 * (flop if rung == "highest" else 3 * flop)
        print(f"split mat step n={n} {rung}: max|diff| vs plain {e:.3e}, "
              f"without the imaginary-table products {e_drop:.3e}; kernel "
              f"{ms:.4f} ms in place ({tf / ms:.1f} TFLOP/s, Karatsuba "
              f"count), flat kernel {flat_ms:.4f} ms"
              + (f" (previous design "
                 f"{BEFORE_MS['fp32 mat step n=24 (flat)']} ms)"
                 if rung == "highest" else
                 f" (previous design: in place "
                 f"{BEFORE_MS['high mat step n=24 (in place)']} ms, flat "
                 f"{BEFORE_MS['high mat step n=24 (flat)']} ms)")
              + f", plain {plain_ms:.4f} ms, library "
              + ("none" if library_ms is None else
                 f"{library_ms:.4f} ms ({tf / library_ms:.1f})")
              + f", bound {bnd[0]:.4f} ms ({bnd[1]})")
        recs[rung] = record(
            "split_mat_step" + ("_high" if rung == "high" else ""), SPLIT_SRC,
            SPLIT_TPU, e, ms, plain_ms, bnd, library_ms)
        del pair, scratch, got
    torch.cuda.empty_cache()

    # the "high" step in place at full width (the default n=30 path), timed
    # beside its previous design; random halves from a generator of their
    # own, so the phases after this one draw as they did
    n30 = FULL_WIDTH
    R30 = 1 << (n30 - PF.LOCAL_QUBITS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n30)
    big = tuple(torch.randn(R30, 128, device="cuda", generator=gen) / 16
                for _ in range(4))
    ms30 = device_ms(torch, lambda: run_split_block(
        scal[i], big, *args, precision="high", high_tables=high[i]),
        reps=3, rounds=3)
    bnd30 = bound(3 * 6.0 * R30 * 256 * 256,
                  16.0 * R30 * 256 + 4 * 256 * 256 * 2, BF16_FLOPS)
    print(f"split mat step n={n30} high: kernel {ms30:.4f} ms in place "
          f"(previous design {BEFORE_MS['high mat step n=30 (in place)']} "
          f"ms), bound {bnd30[0]:.4f} ms ({bnd30[1]})")
    del big
    torch.cuda.empty_cache()
    return block, recs["highest"], recs["high"]


def check_two_streams(torch):
    """Two in-place "high" mat steps in flight at once: each of two
    streams of the card chains TWO_STREAM_STEPS cooperative launches of
    kernel 5's "high" step (whose CTAs count their reads on device-memory
    ints, kernels/split.py ``_high_sync``) on a state and table of its own,
    the launches alternating between the streams; each result must equal
    the same chain on one stream bit for bit, and every stream's counters
    must be zero after it.  Its draws have seeds of their own."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels import split as KS
    from gpu_quantum_simulator_tpu_torch.kernels.block import split_tables

    n = SPLIT_WIDTH
    rng = np.random.default_rng(n + 1)
    gen = torch.Generator(device="cuda").manual_seed(n + 1)
    logt = int(np.log2(PF.tile_rows(n)))
    blocks = [PF._Block(kinds=[0], midx=[0], mats=[
        (random_unitary(rng, 128), tuple(range(7)), None)]) for _ in "ab"]
    scal, a_tab, b_tab, mono_src = split_tables_for(torch, PF, blocks,
                                                    PF.CAP_MATS)
    high = split_tables(a_tab, b_tab)
    R2 = 1 << (n - 8)
    starts = [tuple(torch.randn(R2, 128, device="cuda", generator=gen) / 16
                    for _ in range(4)) for _ in blocks]

    def step(i, halves):
        return KS.run_split_block(
            scal[i], halves, a_tab[i], b_tab[i], mono_src[i], logt,
            PF.CAP_STEPS, precision="high", high_tables=high[i])

    want = [clone4(h) for h in starts]
    for i, h in enumerate(want):
        for _ in range(TWO_STREAM_STEPS):
            step(i, h)
    got = [clone4(h) for h in starts]
    streams = [torch.cuda.Stream() for _ in blocks]
    torch.cuda.synchronize()
    for _ in range(TWO_STREAM_STEPS):
        for i, h in enumerate(got):
            with torch.cuda.stream(streams[i]):
                step(i, h)
    torch.cuda.synchronize()
    dev = starts[0][0].device
    counters = [KS._high_sync(dev, s.cuda_stream) for s in streams]
    same = [equal4(torch, g, w) for g, w in zip(got, want)]
    print(f"two streams n={n}: {TWO_STREAM_STEPS} in-place 'high' mat steps "
          f"on each, alternating; equal to one stream bit for bit {same}; "
          f"counter buffers distinct "
          f"{counters[0].data_ptr() != counters[1].data_ptr()}, zero after "
          f"{[not bool(c.any()) for c in counters]}")
    if not all(same) or any(bool(c.any()) for c in counters) \
            or counters[0].data_ptr() == counters[1].data_ptr():
        raise AssertionError("two streams: the in-place 'high' steps "
                             "disagree with one stream or share counters")
    del got, want, starts, high
    torch.cuda.empty_cache()


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
    high = split_tables(a_tab, b_tab)
    h = random_halves(torch, n)
    tols = {"highest": SPLIT_MAT_TOL, "high": BLOCK_TOL}
    err = 0.0
    for i, (name, _) in enumerate(named):
        assert scal[i][1] == 1 and scal[i][3] == shift
        args = (a_tab[i], b_tab[i], mono_src[i], logt, PF.CAP_STEPS)
        plain_row = scal[i].copy()
        plain_row[1] = 0
        for rung in ("highest", "high") if name == "mat-first" else ("highest",):
            kw = dict(precision=rung, high_tables=high[i])
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


FLAT_KINDS = ("mat", "mat_high", "mat_default", "gather", "folded",
              "relayout", "kh0", "kh0_high", "kh0_default", "block128",
              "vmem", "mm_high", "mm_default")


def check_inplace_counts(n, counts, modes, runs, high, default=False):
    """Launches of ``runs`` in-place runs by kind against the plan's scal
    rows by mode; no flat kernel launched; the mat launches of the run's
    rung only ("high" or "default" when set, else "highest")."""
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
    rung = "split_mat_default" if default else (
        "split_mat_high" if high else "split_mat")
    if any(counts[k] for k in ("split_mat", "split_mat_high",
                               "split_mat_default") if k != rung):
        raise AssertionError(f"n={n} in place: mat launches {counts} at "
                             f"high={high}, default={default}")
    if not counts[rung] > 0:
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
    from gpu_quantum_simulator_tpu_torch.engine import graphs as G
    from gpu_quantum_simulator_tpu_torch.engine import pallas_engine as PE
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S
    from gpu_quantum_simulator_tpu_torch.engine import vmem as V
    from gpu_quantum_simulator_tpu_torch.engine import wide as W

    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP

    for cache in (PF._PROGRAM_CACHE, PF._RUN_CACHE, S._MXU_PLAN_CACHE,
                  W._CACHE, PE._CACHE, V._CACHE, SP._RUN_CACHE):
        cache.clear()
    G.release()
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
    check_halves_routes(torch, parts, n)
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


def check_halves_routes(torch, parts, n):
    """Phase 7 on phase 5's n=30 state: ``marginal_probabilities_halves``
    and ``entanglement_entropy_halves`` on the four halves against the flat
    routes on the joined state (<= 1e-5), timed."""
    from gpu_quantum_simulator_tpu_torch import observables as O
    from gpu_quantum_simulator_tpu_torch.engine.prefetch import join_halves

    qsets = [[q % n for q in qs] for qs in HALVES_QUBITS]
    t0 = time.perf_counter()
    halves_p = [O.marginal_probabilities_halves(*parts, qs, n)
                for qs in qsets]
    halves_s = [O.entanglement_entropy_halves(*parts, cut, n)
                for cut in range(1, 8)]
    t_halves = time.perf_counter() - t0
    re, im = join_halves(*parts)
    t0 = time.perf_counter()
    flat_p = [O.marginal_probabilities(re, im, qs, n) for qs in qsets]
    flat_s = [O.entanglement_entropy(re, im, cut, n) for cut in range(1, 8)]
    t_flat = time.perf_counter() - t0
    del re, im
    torch.cuda.empty_cache()
    e_p = max(float(np.max(np.abs(a - b))) for a, b in zip(halves_p, flat_p))
    e_s = max(abs(a - b) for a, b in zip(halves_s, flat_s))
    print(f"entry points n={n} halves routes: marginals over "
          f"{len(HALVES_QUBITS)} qubit sets max|diff| vs flat {e_p:.3e}, "
          f"entropies cut 1..7 {[round(x, 6) for x in halves_s]} max|diff| "
          f"vs flat {e_s:.3e} (bar {HALVES_TOL:g}); {t_halves:.2f} s on "
          f"the halves, {t_flat:.2f} s flat")
    if not (e_p <= HALVES_TOL and e_s <= HALVES_TOL
            and all(abs(p.sum() - 1) <= HALVES_TOL for p in halves_p)):
        raise AssertionError(f"n={n} halves routes: marginals {e_p}, "
                             f"entropies {e_s}")


def run_inplace_phase(torch, T, refs, add, rng):
    """Phase 5: the kernel checks, the path, sampling, and full width."""
    block, mat, high = check_split_block(torch, rng)
    check_two_streams(torch)
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
    bit for bit; GB/s per variant beside ``copy_``'s, and at every width
    each route's fastest pair copy as a ratio of ``copy_``'s time.  The
    records take each route's fastest pair copy at n=30, with its max
    |dst - src|."""
    from gpu_quantum_simulator_tpu_torch import dma_probe
    from gpu_quantum_simulator_tpu_torch.kernels import copy as KC

    routes = {"grid": ("grid2_", KC.grid_copy),
              "stream": ("stream_", KC.stream_copy),
              "direct": ("direct_", KC.hbm_direct)}
    launches = dict.fromkeys(routes, 0)
    if any(fn.launches for _, fn in routes.values()):
        raise AssertionError("a copy probe kernel ran on an engine path")

    def fastest(res, prefix):
        return max((v for v in res if v.startswith(prefix)),
                   key=lambda v: res[v]["GBps"])

    for n in COPY_WIDTHS:
        KC.reset_launches()
        res = dma_probe.measure(n)
        for k, (_, fn) in routes.items():
            launches[k] += fn.launches
        print(f"copy probe n={n}: " + json.dumps(
            {k: v["GBps"] for k, v in res.items()}))
        lib = res["torch_copy"]
        print(f"copy probe n={n} ratio to copy_ ({lib['ms']:.4f} ms): " +
              ", ".join(f"{k} {fastest(res, p)} "
                        f"{res[fastest(res, p)]['ms'] / lib['ms']:.4f}x"
                        for k, (p, _) in routes.items()))
        bad = [k for k, v in res.items() if not v["exact"]]
        if bad:
            raise AssertionError(f"copy probe n={n}: not bit-exact: {bad}")
        torch.cuda.empty_cache()
    add({f"copy_{k}": v for k, v in launches.items()})
    bnd = bound(nbytes=2.0 * 8 * (1 << COPY_WIDTHS[-1]))
    recs = []
    for k, (prefix, _) in routes.items():
        name = fastest(res, prefix)
        print(f"copy probe n={COPY_WIDTHS[-1]} {k}: fastest {name} "
              f"{res[name]['ms']:.4f} ms ({res[name]['GBps']:.1f} GB/s, "
              f"{res[name]['ms'] / lib['ms']:.4f}x copy_); copy_ "
              f"{lib['ms']:.4f} ms ({lib['GBps']:.1f} GB/s); bound "
              f"{bnd[0]:.4f} ms ({HBM_BYTES / 1e9:.0f} GB/s)")
        recs.append((record(f"copy_{k}", COPY_SRC, COPY_TPU[k],
                            res[name]["max_abs_err"], res[name]["ms"],
                            lib["ms"], bnd, lib["ms"]),
                     f"copy_{k}"))
    return recs


# ------------------------------------------- phase 7: the program entry points
def grover_exact(nd, marked, iterations):
    """Grover's data register after ``iterations`` in float64, by the exact
    algebra the circuit implements: |s> = H^nd |0>, then per iteration the
    oracle I - 2|m><m| and the diffusion I - 2|s><s| (the ancillas return
    to |0>, so the full state is this vector at indices < 2^nd)."""
    size = 1 << nd
    s = np.full(size, size ** -0.5)
    v = s.copy()
    for _ in range(iterations):
        v[marked] = -v[marked]
        v = v - 2.0 * np.dot(s, v) * s
    return v


def per_repetition(torch, fn, reps):
    """(host ms, device ms) per repetition: ``fn`` queues ``reps``
    repetitions; the host clock times the queueing, CUDA events the
    device's work from first to last."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return host, start.elapsed_time(end) / reps, out


def graph_pool_bytes(torch, graph):
    """Bytes of the segments in ``graph``'s private memory pool, or None
    where the allocator's snapshot does not name a segment's pool."""
    pool = tuple(graph.graph.pool())
    total = 0
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        if tuple(seg["segment_pool_id"]) == pool:
            total += seg["total_size"]
    return total


# phase 7's iterated Grover state at 71 repetitions, flat prefetch at
# "highest" (host tensors), for phase 11
PHASE7_GROVER: dict = {}


def check_grover_iterated(torch, T, add, smi):
    """run_device_iterated on Grover at n=24, mxu and flat prefetch, at
    "auto" ("high") and "highest", at GROVER_DEPTHS and the natural 71
    repetitions (one capture, then replays).  Held: at GROVER_DEPTHS[0]
    the graph's result equals the eager loop of the same body program
    from the prefix's state bit for bit; at every depth the launch counts
    equal the prefix's plus the body's once a repetition (and once more
    for the warm-up of the first call), and the result is within the
    rung's bar of the reference: at "high" the unrolled circuit's
    run_device at that depth (prefetch, "auto"), at "highest" the exact
    f64 state.  The bar (HIGH_TOL "high", AMP_TOL "highest") scales with
    the peak amplitude (PERF.md section 2) and with the run's fused ops
    over BENCH_OPS: every repetition applies the same rounded tables, so
    the rounding adds up with depth; the three depths measure that
    growth.  At 71 the peak is at the marked state.  Host and device ms a
    repetition, graph replays against the eager loop; the graph's pool and
    its end copy.  Every reading is printed before any bar is applied."""
    from gpu_quantum_simulator_tpu_torch.engine import graphs as G
    from gpu_quantum_simulator_tpu_torch.ops.apply import (
        initial_state_parts, unpermute_device)

    nd, marked = GROVER_DATA, GROVER_MARKED
    prefix, body, iters = T.models.grover_parts(nd, marked)
    depths = (*GROVER_DEPTHS, iters)
    n = prefix.num_qubits
    exact, unrolled, scale = {}, {}, {}
    ref_sim = T.Simulator(T.SimulatorConfig(strategy="prefetch"),
                          device="cuda")
    for reps in depths:
        e = torch.zeros(1 << n, dtype=torch.float64)
        e[:1 << nd] = torch.from_numpy(grover_exact(nd, marked, reps))
        exact[reps] = e.cuda()
        scale[reps] = max(1.0, float(e.abs().max()) / HIGH_BAR_PEAK)
        c = T.models.grover(nd, marked, iterations=reps)
        t0 = time.perf_counter()
        unrolled[reps] = ref_sim.run_device(c)
        amp = torch.complex(unrolled[reps][0].double(),
                            unrolled[reps][1].double())
        print(f"entry points grover n={n} x{reps}: unrolled circuit of "
              f"{len(c.gates)} gates, prefetch \"auto\" run_device "
              f"{unrolled[reps][2]} ops in "
              f"{time.perf_counter() - t0:.2f} s (fusion, plan and tables "
              f"included); vs exact f64 "
              f"{float((amp - exact[reps]).abs().max()):.3e}")
        del amp
    del ref_sim
    clear_caches(torch)
    failed = []
    for strategy in ENTRY_STRATEGIES:
        for rung in ENTRY_RUNGS:
            sim = T.Simulator(T.SimulatorConfig(strategy=strategy,
                                                precision=rung),
                              device="cuda")
            high = sim.config.effective_precision(n) == "high"
            got, counts, nops = {}, {}, {}
            for reps in (iters, *GROVER_DEPTHS):
                reset_counts()
                t0 = time.perf_counter()
                re, im, nops[reps] = sim.run_device_iterated(
                    body, reps, prefix=prefix)
                torch.cuda.synchronize()
                if reps == iters:
                    first = time.perf_counter() - t0
                    if (strategy, rung) == ("prefetch", "highest"):
                        # phase 11 holds the sharded iterated run to it
                        PHASE7_GROVER.update(re=re.cpu(), im=im.cpu(),
                                             ops=nops[reps])
                counts[reps] = launch_counts()
                got[reps] = (re, im)
                del re, im
            add(counts[iters])
            perm, programs = sim._iterated_programs(body, iters, prefix)
            (pre, _, _), (prog, body_ops, _) = programs
            graph = G._LIVE[torch.device("cuda", 0)]
            same_prog = graph.prog is prog
            pool = graph_pool_bytes(torch, graph)
            # one call of each program, counted, from a fresh prefix state
            reset_counts()
            x0 = pre(*initial_state_parts(n, device="cuda"))
            pre_counts = launch_counts()
            reset_counts()
            xin = (x0[0].clone(), x0[1].clone())
            one = prog(*xin)
            body_counts = launch_counts()
            copies = one[0].data_ptr() != xin[0].data_ptr()
            del one, xin
            counted = all(
                counts[r] == {k: pre_counts[k] + body_counts[k]
                              * (r + (r == iters)) for k in pre_counts}
                for r in depths)
            R = GROVER_DEPTHS[0]

            def eager():
                e = (x0[0].clone(), x0[1].clone())
                for _ in range(R):
                    e = prog(*e)
                return e

            eh, ed, want = per_repetition(torch, eager, R)
            if perm is not None:
                want = unpermute_device(*want, [int(p) for p in perm])
            bit = (torch.equal(want[0], got[R][0])
                   and torch.equal(want[1], got[R][1]))
            del want, x0

            def replays():
                for _ in range(GRAPH_TIMED):
                    graph.graph.replay()

            gh, gd, _ = per_repetition(torch, replays, GRAPH_TIMED)
            copy_ms = (device_ms(torch, lambda: (graph.re.copy_(got[R][0]),
                                                 graph.im.copy_(got[R][1])),
                                 reps=5, rounds=3) if copies else None)
            del graph
            rows = []
            for reps in depths:
                amp = torch.complex(got[reps][0].double(),
                                    got[reps][1].double())
                e_exact = float((amp - exact[reps]).abs().max())
                peak_at = int(torch.argmax(amp.abs()))
                del amp
                err = (max_diff(got[reps], unrolled[reps][:2]) if high
                       else e_exact)
                bar = ((HIGH_TOL if high else AMP_TOL) * scale[reps]
                       * max(1.0, nops[reps] / BENCH_OPS))
                rows.append((reps, nops[reps], err, bar, e_exact, peak_at))
            del got
            pool_txt = ("not measured" if pool is None
                        else f"{pool / 2**20:.1f} MiB")
            copy_txt = "none" if copy_ms is None else f"{copy_ms:.4f} ms"
            print(f"entry points grover n={n} {strategy} {rung} "
                  f"({'high' if high else 'highest'}): a {body_ops}-op body;"
                  f" first call ({iters} repetitions) {first:.3f} s (build, "
                  f"warm-up and capture included); per repetition graph "
                  f"replay host {gh:.4f} ms device {gd:.4f} ms, eager loop "
                  f"({R} repetitions) host {eh:.4f} ms device {ed:.4f} ms; "
                  f"run_device_iterated (graph) "
                  f"{'equals' if bit else 'DIFFERS FROM'} the eager loop bit "
                  f"for bit at {R}; the live graph "
                  f"{'holds' if same_prog else 'DOES NOT HOLD'} the cached "
                  f"body program; graph pool {pool_txt}; end copy "
                  f"{copy_txt}; launches "
                  f"{'equal' if counted else 'DIFFER FROM'} prefix + body x "
                  f"repetitions (+1 warm-up), at {iters}: {counts[iters]}; "
                  f"{smi}")
            for reps, ops, err, bar, e_exact, peak_at in rows:
                print(f"  x{reps} ({ops} ops): vs "
                      f"{'unrolled' if high else 'exact f64'} {err:.3e} "
                      f"(bar {bar:.3e}), vs exact f64 {e_exact:.3e}; peak "
                      f"at {peak_at}")
            if not (bit and counted and same_prog and rows[-1][5] == marked
                    and all(r[2] <= r[3] for r in rows)):
                failed.append((strategy, rung, bit, counted, same_prog,
                               rows))
            clear_caches(torch)
    del unrolled, exact
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"grover iterated: (strategy, rung, bit for "
                             f"bit, launches counted, same program, "
                             f"[(repetitions, ops, error, bar, vs exact, "
                             f"peak at)]) {failed}")


def check_trotter(torch, T, add, smi):
    """Trotter TFIM at n=28 on mxu through run_device_iterated at
    "highest": the state against the unrolled circuit's run_device at the
    same rung (prefetch: its tables build ~30x faster than mxu's) within
    the rung's bar; <H> by the "state" method's sum (``_pauli_sum_parts``)
    on the iterated state against expectation_pauli_sum(method="basis")
    on the unrolled circuit (prefetch, "highest") within TROTTER_TOL, the
    same sum in float64 printed beside it; the norm, and the entanglement
    entropy at the middle cut > 0."""
    from gpu_quantum_simulator_tpu_torch import observables as O

    n, dt, steps = TROTTER
    prefix, body, steps = T.models.trotter_tfim_parts(n, dt, steps=steps)
    unrolled = T.models.trotter_tfim(n, dt, steps=steps)
    terms = T.models.tfim_terms(n)
    parsed, const = O._parse_terms(terms, n)
    sim = T.Simulator(T.SimulatorConfig(strategy="mxu",
                                        precision="highest"), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    re, im, nops = sim.run_device_iterated(body, steps, prefix=prefix)
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    add(launch_counts())
    clear_caches(torch)
    cut = n // 2
    t0 = time.perf_counter()
    entropy = O.entanglement_entropy(re, im, cut, n)
    t_entropy = time.perf_counter() - t0
    norm = float(torch.dot(re, re) + torch.dot(im, im))
    t0 = time.perf_counter()
    e_state = const + float(O._pauli_sum_parts(re, im, parsed, n))
    t_state = time.perf_counter() - t0
    e_f64 = const + float(O._pauli_sum_parts(re.double(), im.double(),
                                             parsed, n))
    cfg = T.SimulatorConfig(strategy="prefetch", precision="highest")
    t0 = time.perf_counter()
    ref = T.Simulator(cfg, device="cuda").run_device(unrolled)
    t_unrolled = time.perf_counter() - t0
    err = max_diff((re, im), ref[:2])
    peak = float(torch.maximum(ref[0].abs(), ref[1].abs()).max())
    bar = (AMP_TOL * max(1.0, peak / HIGH_BAR_PEAK)
           * max(1.0, nops / BENCH_OPS))
    del re, im, ref
    clear_caches(torch)
    reset_counts()
    t0 = time.perf_counter()
    e_basis = O.expectation_pauli_sum(unrolled, terms, cfg, method="basis")
    t_basis = time.perf_counter() - t0
    add(launch_counts())
    clear_caches(torch)
    print(f"entry points trotter tfim n={n}: {steps} steps ({nops} ops) "
          f"iterated on mxu at \"highest\" in {t_iter:.3f} s (build, "
          f"warm-up and capture included), norm {norm:.7f}, vs the unrolled "
          f"circuit (prefetch \"highest\", {t_unrolled:.2f} s) {err:.3e} "
          f"(bar {bar:.3e}), entropy at cut {cut} {entropy:.6f} bits "
          f"({t_entropy:.2f} s); <H> on the iterated state {e_state:.7f} "
          f"({t_state:.2f} s; float64 sums {e_f64:.7f}) vs basis "
          f"{e_basis:.7f} ({t_basis:.2f} s), |diff| "
          f"{abs(e_state - e_basis):.3e} (bar {TROTTER_TOL:g}), float64 "
          f"sums {abs(e_f64 - e_basis):.3e}; {smi}")
    if not (abs(e_state - e_basis) <= TROTTER_TOL and err <= bar
            and entropy > 0 and abs(norm - 1) <= NORM_TOL):
        raise AssertionError(f"trotter n={n}: state {e_state}, basis "
                             f"{e_basis}, vs unrolled {err} (bar {bar}), "
                             f"entropy {entropy}, norm {norm}")


def check_graph_memory(torch, T, add, smi):
    """A sweep of distinct QAOA bodies at n=28 through run_device_iterated
    on the default config (mxu, "high" there), as an angle scan runs it:
    the card keeps one live graph, so the peak and the held device memory
    after the last body stay within GRAPH_MEMORY_SLACK of the first
    body's (each graph kept besides would hold its static pair and pool,
    about two states).  The results' norms are printed, not held: the
    "high" rung rounds these phase tables alike in every entry, so the
    norm moves ~1e-6 a fused op (the plain version's arithmetic does the
    same on the CPU), and Grover and Trotter hold the entry points'
    amplitudes."""
    from gpu_quantum_simulator_tpu_torch.engine import graphs as G

    n, count, reps = GRAPH_MEMORY
    clear_caches(torch)
    torch.cuda.reset_peak_memory_stats()
    sim = T.Simulator(device="cuda")
    rng = np.random.default_rng(n)
    peaks, held, norms = [], [], []
    reset_counts()
    t0 = time.perf_counter()
    for gamma, beta in rng.uniform(0.1, 1.2, size=(count, 2)):
        prefix, body, _ = T.models.qaoa_maxcut_parts(
            n, gamma=float(gamma), beta=float(beta))
        re, im, _ = sim.run_device_iterated(body, reps, prefix=prefix)
        norms.append(float(torch.dot(re, re) + torch.dot(im, im)))
        del re, im
        if not peaks:
            pool = graph_pool_bytes(torch, G._LIVE[torch.device("cuda", 0)])
        peaks.append(torch.cuda.max_memory_reserved())
        held.append(torch.cuda.memory_reserved())
    t = time.perf_counter() - t0
    add(launch_counts())
    clear_caches(torch)
    gib = float(1 << 30)
    pool_txt = "not measured" if pool is None else f"{pool / gib:.3f} GiB"
    print(f"entry points graph memory n={n}: {count} distinct qaoa bodies "
          f"x{reps} on the default config in {t:.2f} s; the first graph's "
          f"pool {pool_txt}; peak reserved after "
          f"each {[round(p / gib, 3) for p in peaks]} GiB, held "
          f"{[round(h / gib, 3) for h in held]} GiB (slack "
          f"{GRAPH_MEMORY_SLACK / gib:g} GiB); norms "
          f"{[round(x, 7) for x in norms]}; {smi}")
    if not (peaks[-1] - peaks[0] <= GRAPH_MEMORY_SLACK
            and max(held) - held[0] <= GRAPH_MEMORY_SLACK
            and all(np.isfinite(norms))):
        raise AssertionError(f"graph memory n={n}: peaks {peaks}, held "
                             f"{held}, norms {norms}")


def check_device_parts(torch, T, add):
    """run_device_parts at n=24 on the default config ("auto", "high"
    there): the two halves of grover_like(24, PARTS_GATES, 318) run in turn
    equal the whole within the rung's bar, and the caller's tensors are
    unchanged."""
    n = PARTS_WIDTH
    c = T.models.grover_like(n, PARTS_GATES, 318)
    half = len(c.gates) // 2
    first = T.Circuit(n, list(c.gates[:half]))
    second = T.Circuit(n, list(c.gates[half:]))
    sim = T.Simulator(device="cuda")
    reset_counts()
    re0 = torch.zeros(1 << n, device="cuda")
    re0[0] = 1.0
    im0 = torch.zeros_like(re0)
    keep = (re0.clone(), im0.clone())
    mid = sim.run_device_parts(first, (re0, im0))
    kept_mid = (mid[0].clone(), mid[1].clone())
    out = sim.run_device_parts(second, mid[:2])
    whole = sim.run_device_parts(c, (re0, im0))
    torch.cuda.synchronize()
    add(launch_counts())
    unchanged = all(torch.equal(a, b) for a, b in
                    ((re0, keep[0]), (im0, keep[1]), (mid[0], kept_mid[0]),
                     (mid[1], kept_mid[1])))
    err = max_diff(out[:2], whole[:2])
    print(f"entry points run_device_parts n={n} auto: halves of {mid[2]} + "
          f"{out[2]} ops vs the whole ({whole[2]} ops) max|diff| {err:.3e} "
          f"(bar {HIGH_TOL:g}); the caller's tensors "
          f"{'unchanged' if unchanged else 'CHANGED'}")
    if not (unchanged and err <= HIGH_TOL):
        raise AssertionError(f"run_device_parts: {err}, unchanged "
                             f"{unchanged}")
    del mid, out, whole
    torch.cuda.empty_cache()


def check_run_many(torch, T, add, smi):
    """run_many at n=24 (the default config): eight qaoa_maxcut candidates
    in terms mode with maxcut_cost_terms against each circuit's
    expectation_pauli_sum (<= 1e-5), states mode against run.  Its
    dispatch path (``_run_device`` and the terms' sum, new circuits: fusion,
    plan, table upload and launches) runs under torch's sync debug mode
    set to "error": any wait for the device there raises.  Wall time
    against the same work waiting for each circuit (run_device, then the
    terms' sum fetched): on new circuits (set A for run_many, set B for the
    waiting loop), then on set B again, its programs cached (the plan
    cache holds eight), beside the loop of expectation_pauli_sum."""
    from gpu_quantum_simulator_tpu_torch import observables as O

    n, count = MANY
    rng = np.random.default_rng(2445)
    sets = [[T.models.qaoa_maxcut(n, gammas=tuple(a[0]), betas=tuple(a[1]))
             for a in rng.uniform(0.1, 1.2, size=(count, 2, 2))]
            for _ in range(2)]
    cs = sets[1]
    terms = T.models.maxcut_cost_terms(n)
    parsed, const = O._parse_terms(terms, n)
    sim = T.Simulator(device="cuda")
    sim.run_device(T.models.qaoa_maxcut(n))     # the card and cuBLAS warm

    def waiting(circuits):
        out = []
        for c in circuits:
            re, im, _ = sim.run_device(c)
            out.append(const + float(O._pauli_sum_parts(re, im, parsed, n)))
        return np.asarray(out)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    fresh = [T.models.qaoa_maxcut(n, gammas=(0.3, 0.5), betas=(0.2, 0.7)),
             T.models.qaoa_maxcut(n, gammas=(0.9, 0.1), betas=(0.6, 0.4))]
    queued = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in fresh:
            re, im, _ = sim._run_device(c)
            queued.append(O._pauli_sum_parts(re, im, parsed, n))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    no_wait = [const + float(q) for q in queued]
    reset_counts()
    t_many, _ = timed(lambda: sim.run_many(sets[0], terms=terms))
    add(launch_counts())
    t_seq, first = timed(lambda: waiting(cs))
    t_many_warm, got = timed(lambda: sim.run_many(cs, terms=terms))
    t_seq_warm, seq = timed(lambda: waiting(cs))
    t_loop, want = timed(lambda: np.asarray(
        [O.expectation_pauli_sum(c, terms) for c in cs]))
    states = sim.run_many(cs[:2])
    same = all(np.array_equal(s, sim.run(c)) for s, c in zip(states, cs))
    err = float(np.max(np.abs(got - want)))
    repeat = (np.array_equal(got, first) and np.array_equal(got, seq)
              and np.array_equal(no_wait, waiting(fresh)))
    print(f"entry points run_many n={n}: {count} qaoa candidates, <C> "
          f"{np.round(got, 5).tolist()}; dispatch of {len(fresh)} new "
          f"circuits under sync debug mode \"error\": no wait; new "
          f"circuits: run_many(terms=) {t_many:.3f} s, waiting per circuit "
          f"{t_seq:.3f} s; programs cached: run_many {t_many_warm:.3f} s, "
          f"waiting {t_seq_warm:.3f} s, the loop of expectation_pauli_sum "
          f"{t_loop:.3f} s; max|diff| vs expectation_pauli_sum {err:.3e} "
          f"(bar {MANY_TOL:g}); run_many "
          f"{'equals' if repeat else 'DIFFERS FROM'} the waiting loop bit "
          f"for bit; states mode {'equals' if same else 'DIFFERS FROM'} "
          f"run; {smi}")
    if not (err <= MANY_TOL and same and repeat):
        raise AssertionError(f"run_many n={n}: {err}, states equal {same}, "
                             f"repeat equal {repeat}")
    torch.cuda.empty_cache()


def plain_join(re, im):
    """The join as numpy writes it: the parts into a new complex array."""
    out = np.empty(re.shape, np.complex64 if re.dtype == np.float32
                   else np.complex128)
    out.real = re
    out.imag = im
    return out


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint32 if a.dtype == np.complex64 else np.uint64),
        b.view(np.uint32 if b.dtype == np.complex64 else np.uint64)))


def check_join(torch, T, smi):
    """``join_state`` of parts on the card (ops/apply.py): bit for bit the
    plain join of the parts fetched whole, at chunks of 64 elements over
    every case of the CPU tests (tests/test_torch_join.py) and a strided
    part, then at n=28 with the default chunk behind a queued second of
    device work (the output is ready before the card is: the overlapped
    counter moves), timed against the plain join on an idle card;
    ``run_detailed`` at n=24 is the join of ``run_device``'s parts."""
    from gpu_quantum_simulator_tpu_torch import telemetry
    from gpu_quantum_simulator_tpu_torch.ops import apply as A

    default = A.CHUNK_BYTES
    gen = torch.Generator(device="cuda").manual_seed(2445)
    shapes = [(40,), (64,), (209,), (2, 16), (4, 16), (5, 32)]
    cases = 0
    try:
        for dt in (torch.float32, torch.float64):
            A.CHUNK_BYTES = 64 * torch.empty((), dtype=dt).element_size()
            for shape in shapes:
                re, im = (torch.randn(shape, generator=gen, device="cuda",
                                      dtype=dt) for _ in range(2))
                want = plain_join(re.cpu().numpy(), im.cpu().numpy())
                if not same_bits(A.join_state(re, im), want):
                    raise AssertionError(f"join_state {shape} {dt} differs "
                                         "from the plain join")
                cases += 1
            wide = torch.randn((64, 7), generator=gen, device="cuda",
                               dtype=dt)
            got = A.join_state(wide.t(), -wide.t())
            if not same_bits(got, plain_join(wide.t().cpu().numpy(),
                                             -wide.t().cpu().numpy())):
                raise AssertionError(f"join_state of strided {dt} parts "
                                     "differs from the plain join")
            cases += 1
    finally:
        A.CHUNK_BYTES = default

    n = 28
    re, im = (torch.randn(1 << n, generator=gen, device="cuda")
              for _ in range(2))
    host = (re.cpu().numpy(), im.cpu().numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain_join(host[0], host[1])
    plain_s = time.perf_counter() - t0
    del want
    t0 = time.perf_counter()
    fetched = plain_join(A._to_host(re), A._to_host(im))
    old_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = A.join_state(re, im)
    idle_s = time.perf_counter() - t0
    if not same_bits(got, fetched):
        raise AssertionError("join_state at n=28 differs from the plain join")
    del got
    cycles = int(1.5e9)
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    sleep_s = time.perf_counter() - t0
    before = telemetry.counters()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    got = A.join_state(re, im)
    busy_s = time.perf_counter() - t0
    after = telemetry.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("state_joins", "state_join_overlapped")}
    if not same_bits(got, fetched) or moved != {
            "state_joins": 1, "state_join_overlapped": 1}:
        raise AssertionError(f"join_state behind device work: counters "
                             f"{moved}, equal {same_bits(got, fetched)}")
    del got, fetched, re, im, host

    sim = T.Simulator(device="cuda")
    c = T.models.grover_like(24, 2445, 318)
    state = sim.run_detailed(c).state
    pre, pim, _ = sim.run_device(c)
    if not same_bits(state, plain_join(pre.cpu().numpy(), pim.cpu().numpy())):
        raise AssertionError("run_detailed n=24 is not the join of "
                             "run_device's parts")
    del state, pre, pim
    print(f"entry points join_state: {cases} chunked cases bit for bit; "
          f"n={n} (2 x 1 GiB float32 parts, chunks of "
          f"{default >> 20} MiB a part, {torch.get_num_threads()} intra-op "
          f"threads, {os.cpu_count()} cpus, page {mmap.PAGESIZE} B): "
          f"plain numpy join of host parts {plain_s:.3f} s, the former "
          f"join (two pinned copies, then numpy) {old_s:.3f} s, join_state "
          f"on an idle card {idle_s:.3f} s; behind {sleep_s:.3f} s of "
          f"device sleep {busy_s:.3f} s (exposed about "
          f"{busy_s - sleep_s:.3f} s), counters {moved}; run_detailed "
          f"n=24 = join of run_device bit for bit; {smi}")
    torch.cuda.empty_cache()


def run_entry_points(torch, T, add, smi):
    """Phase 7: the facade's program entry points at full width (the
    halves routes ran on phase 5's n=30 state)."""
    t0 = time.perf_counter()
    check_grover_iterated(torch, T, add, smi)
    check_graph_memory(torch, T, add, smi)
    check_trotter(torch, T, add, smi)
    check_device_parts(torch, T, add)
    check_run_many(torch, T, add, smi)
    check_join(torch, T, smi)
    clear_caches(torch)
    print(f"entry points: phase 7 in {time.perf_counter() - t0:.1f} s")


def cli(*args):
    """``python -m gpu_quantum_simulator_tpu_torch *args`` in this process
    (its launches count): (wall seconds, stdout lines); a non-zero exit
    raises with its stderr."""
    import contextlib
    import io

    from gpu_quantum_simulator_tpu_torch.__main__ import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main([str(a) for a in args])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI {args}: exit {rc}: {err.getvalue()}")
    return wall, out.getvalue().splitlines()


def qasm_file(tmp, name, c):
    import os

    path = os.path.join(tmp, f"{name}.qasm")
    with open(path, "w") as f:
        f.write(c.to_qasm())
    return path


def loaded_state(path):
    """(complex host state, meta) of a flat checkpoint."""
    from gpu_quantum_simulator_tpu_torch.ops.apply import join_state
    from gpu_quantum_simulator_tpu_torch.utils.checkpoint import load_state

    re, im, meta = load_state(path)
    return join_state(re, im), meta


def check_cli_default(torch, T, tmp, add):
    """The CLI's default config at n=24 (mxu, "auto" -> "high"), --json
    --save-state: the checkpoint equals Simulator().run of the same circuit
    bit for bit, and the parsed circuit hits the plan cache that run
    filled (to_qasm writes repr floats, which parse back exactly)."""
    import os

    from gpu_quantum_simulator_tpu_torch.engine import simulator as S

    n = CLI_WIDTH
    c = T.models.grover_like(n, 2445, 318)
    path = qasm_file(tmp, f"grover_like_{n}", c)
    parsed = T.parse_qasm_file(path)
    same_gates = [(g.name, g.qubits, g.params) for g in parsed.gates] == \
        [(g.name, g.qubits, g.params) for g in c.gates]
    t0 = time.perf_counter()
    want = T.Simulator(device="cuda").run(c)
    t_direct = time.perf_counter() - t0
    keys = set(S._MXU_PLAN_CACHE)
    ck = os.path.join(tmp, "default.npz")
    reset_counts()
    wall, out = cli(path, "--json", "--save-state", ck)
    counts = launch_counts()
    add(counts)
    hit = set(S._MXU_PLAN_CACHE) == keys
    rec = json.loads(out[0])
    got, meta = loaded_state(ck)
    equal = np.array_equal(got, want)
    print(f"CLI n={n} default config: {rec['strategy']}, "
          f"{rec['num_fused_ops']} ops, CLI seconds {rec['seconds']:.4f}, "
          f"main() wall {wall:.4f} s (Simulator().run first, tables built: "
          f"{t_direct:.4f} s); parsed circuit "
          f"{'equals' if same_gates else 'DIFFERS FROM'} the generated one; "
          f"plan cache {'HIT' if hit else 'MISSED'}; checkpoint "
          f"{'equals' if equal else 'DIFFERS FROM'} Simulator().run bit for "
          f"bit; mm_high launches {counts['mm_high']}")
    if not (equal and hit and same_gates and rec["strategy"] == "mxu"
            and counts["mm_high"] > 0 and meta["num_qubits"] == n):
        raise AssertionError(f"CLI default n={n}: equal {equal}, cache hit "
                             f"{hit}, gates {same_gates}, {rec}, {counts}")


def check_cli_prefetch(torch, T, tmp, refs, add):
    """--strategy prefetch --precision highest at n=22 through the CLI,
    held to the f64 reference phase 4 holds (1e-6)."""
    import os

    n = CLI_FLAT
    path = qasm_file(tmp, f"grover_like_{n}", T.models.grover_like(
        n, 2445, 318))
    ck = os.path.join(tmp, "prefetch.npz")
    reset_counts()
    wall, out = cli(path, "--strategy", "prefetch", "--precision", "highest",
                    "--save-state", ck)
    counts = launch_counts()
    add(counts)
    got, _ = loaded_state(ck)
    err = float(np.max(np.abs(got - refs[n])))
    print(f"CLI n={n} prefetch 'highest': CLI seconds {float(out[0]):.4f}, "
          f"main() wall {wall:.4f} s; max|amp - f64| {err:.3e} (bar "
          f"{AMP_TOL:g}); launches {counts}")
    if not (err <= AMP_TOL and counts["mat"] > 0):
        raise AssertionError(f"CLI prefetch n={n}: {err}, {counts}")


def check_cli_inplace(torch, T, tmp, add):
    """--inplace --strategy prefetch at n=24 ("high"): the first gates of
    the circuit, their halves saved; the rest resumed from that file and
    saved again, held to the flat prefetch run of the whole circuit (two
    "high" runs, each within HIGH_TOL of "highest")."""
    import os

    from gpu_quantum_simulator_tpu_torch.engine.prefetch import join_halves
    from gpu_quantum_simulator_tpu_torch.ops.apply import join_state
    from gpu_quantum_simulator_tpu_torch.utils.checkpoint import (
        load_state_halves)

    n, cut = CLI_INPLACE
    c = T.models.grover_like(n, 2445, 318)
    first = qasm_file(tmp, "first", T.Circuit(n, list(c.gates[:cut])))
    second = qasm_file(tmp, "second", T.Circuit(n, list(c.gates[cut:])))
    mid, end = os.path.join(tmp, "mid.npz"), os.path.join(tmp, "end.npz")
    reset_counts()
    w1, out1 = cli(first, "--inplace", "--strategy", "prefetch", "--json",
                   "--save-state", mid)
    w2, out2 = cli(second, "--inplace", "--strategy", "prefetch", "--json",
                   "--load-state", mid, "--save-state", end)
    counts = launch_counts()
    add(counts)
    parts, meta = load_state_halves(end)
    got = join_state(*join_halves(*(torch.from_numpy(p) for p in parts)))
    want = T.Simulator(T.SimulatorConfig(strategy="prefetch"),
                       device="cuda").run(c)
    err = float(np.max(np.abs(got - want)))
    peak = float(np.max(np.abs(want)))
    tol = 2 * HIGH_TOL * max(1.0, peak / HIGH_BAR_PEAK)
    recs = [json.loads(o[0]) for o in (out1, out2)]
    print(f"CLI n={n} --inplace: {cut} gates then {len(c.gates) - cut} "
          f"resumed from the halves checkpoint, CLI seconds "
          f"{recs[0]['seconds']:.4f} + {recs[1]['seconds']:.4f}, norms "
          f"{recs[0]['norm']:.8f}, {recs[1]['norm']:.8f}; vs the flat run "
          f"of the whole circuit max|diff| {err:.3e} (bar {tol:.3e}); "
          f"launches {counts}")
    in_place = sum(v for k, v in counts.items() if k.startswith("split_"))
    if not (err <= tol and all(r["split_state"] for r in recs)
            and in_place > 0 and meta["layout"] == "halves"):
        raise AssertionError(f"CLI --inplace n={n}: {err}, {counts}")


def check_cli_subprocess(tmp, T):
    """One ``python -m gpu_quantum_simulator_tpu_torch`` process with no
    --device flag: it runs on the card, exits 0 and prints one float
    first."""
    import os

    path = qasm_file(tmp, "ghz_18", T.models.ghz(18))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_quantum_simulator_tpu_torch", path,
         "--amplitudes", "2"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    print(f"CLI process (no --device): exit {proc.returncode} in "
          f"{wall:.2f} s, stdout {lines}")
    if proc.returncode != 0:
        raise AssertionError(f"CLI process: {proc.stderr}")
    float(lines[0])
    if not (len(lines) == 3 and "p=0.500000" in lines[1]):
        raise AssertionError(f"CLI process output: {lines}")


def time_ablation(torch, T, tmp=None, strategies=ABLATION_STRATEGIES):
    """The reference's ablation rows at n=18 through the CLI on
    grover_like(18, 2445, 318): per strategy one warm-up and
    ABLATION_RUNS timed runs (the CLI's seconds, and main()'s wall time,
    which adds the parse and the checkpoint write); the last run saves its
    state.  Returns {strategy: (CLI seconds, walls, state, json record)}."""
    import os
    import tempfile

    own = tmp is None
    if own:
        holder = tempfile.TemporaryDirectory()
        tmp = holder.name
    n = ABLATION_WIDTH
    path = qasm_file(tmp, f"grover_like_{n}", T.models.grover_like(
        n, 2445, 318))
    rows = {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for strategy in strategies:
        ck = os.path.join(tmp, f"{strategy}.npz")
        cli(path, "--strategy", strategy)
        secs, walls = [], []
        for i in range(ABLATION_RUNS):
            extra = ("--json", "--save-state", ck) \
                if i == ABLATION_RUNS - 1 else ("--json",)
            wall, out = cli(path, "--strategy", strategy, *extra)
            rec = json.loads(out[0])
            secs.append(rec["seconds"])
            walls.append(wall)
        state, _ = loaded_state(ck)
        rows[strategy] = (secs, walls, state, rec)
        print(f"ablation n={n} {strategy}: CLI seconds median "
              f"{np.median(secs):.4f} (runs {[round(x, 4) for x in secs]}), "
              f"main() wall median {np.median(walls):.4f} s, "
              f"{rec['num_fused_ops']} ops; {smi}")
    if own:
        holder.cleanup()
    return rows


def check_ablation(torch, T, tmp, refs, add):
    """The ablation rows held to the f64 reference (per-gate engines
    PER_GATE_TOL, mxu and prefetch AMP_TOL); naive and scan dispatched
    once more under torch's sync debug mode "error" (no wait for the
    device between gates or table rows), equal to their CLI runs bit for
    bit, with their peak device memory above the state."""
    from gpu_quantum_simulator_tpu_torch.ops.apply import join_state

    n = ABLATION_WIDTH
    reset_counts()
    rows = time_ablation(torch, T, tmp)
    add(launch_counts())
    bad = []
    for strategy, (_, _, state, _) in rows.items():
        tol = AMP_TOL if strategy in ("mxu", "prefetch") else PER_GATE_TOL
        err = float(np.max(np.abs(state - refs[n])))
        print(f"ablation n={n} {strategy}: max|amp - f64| {err:.3e} (bar "
              f"{tol:g})")
        if not err <= tol:
            bad.append((strategy, err))
    c = T.models.grover_like(n, 2445, 318)
    for strategy in SYNC_CHECKED:
        sim = T.Simulator(T.SimulatorConfig(strategy=strategy),
                          device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            re, im, _ = sim._run_device(c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t_dispatch = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_done = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        same = np.array_equal(join_state(re, im), rows[strategy][2])
        print(f"ablation n={n} {strategy} under sync debug mode \"error\": "
              f"no wait; dispatch {t_dispatch:.4f} s, done {t_done:.4f} s; "
              f"peak device memory {peak / 2 ** 20:.2f} MiB above the "
              f"{(2 ** (n + 3)) / 2 ** 20:.0f} MiB state pair; "
              f"{'equals' if same else 'DIFFERS FROM'} its CLI run bit for "
              f"bit")
        if not same:
            bad.append((strategy, "sync-checked run differs"))
        del re, im
    if bad:
        raise AssertionError(f"ablation rows: {bad}")


def run_cli_phase(torch, T, refs, add):
    """Phase 8: the CLI and the per-gate strategies."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        check_cli_default(torch, T, tmp, add)
        clear_caches(torch)
        check_cli_prefetch(torch, T, tmp, refs, add)
        check_cli_inplace(torch, T, tmp, add)
        clear_caches(torch)
        check_cli_subprocess(tmp, T)
        check_ablation(torch, T, tmp, refs, add)
    clear_caches(torch)
    print(f"CLI: phase 8 in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------ phase 9: workloads on the state
GRAD_WIDTH = 20             # adjoint vs parameter shift, prefetch "highest"
GRAD_TOL = 1e-4
GRAD_GATES = 6
WIDE_GRAD_WIDTH = 24        # adjoint on the default config (mxu, "high")
TIE_TOL = 1e-4              # value_and_grad vs adjoint, relative to max|g|
VQE_WIDTH, VQE_STEPS = 20, 40
RESTART_WIDTH, RESTARTS, RESTART_STEPS = 16, 4, 20
LANDSCAPE_SIDE = 12         # a 12 x 12 (gamma, beta) grid at n=16
ENSEMBLE_N, ENSEMBLE_SHOTS = 20, 256    # n + s = 28 on the default config
ENSEMBLE_NORM_TOL = 1e-5
PER_SHOT_N = 12
NOISE_N, NOISE_SHOTS = 10, 4096
NOISELESS_TOL = 1e-5
ZNE_N = 16
DENSITY_N, DENSITY_INPLACE_N = 12, 15
TRACE_TOL = 1e-5
SHADOW_N, SHADOW_SNAPSHOTS = 20, 4000
QAOA_ANGLES = dict(gammas=(0.7, 0.3), betas=(0.4, 0.2))


class no_wait:
    """torch's sync debug mode "error" for the block: any host wait for
    the card inside it raises."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        return False


def fresh_peak(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def peak_gib(torch):
    torch.cuda.synchronize()
    return torch.cuda.max_memory_reserved() / 2 ** 30


def ghz_dynamic_qasm(n):
    """GHZ-n, a mid-circuit measure of qubit 0, a reset, a conditional X
    that restores it, then every qubit measured: all n + 1 bits equal."""
    lines = ["OPENQASM 3.0;", 'include "stdgates.inc";', f"qubit[{n}] q;",
             f"bit[{n + 1}] c;", "h q[0];"]
    lines += [f"cx q[{i - 1}], q[{i}];" for i in range(1, n)]
    lines += ["c[0] = measure q[0];", "reset q[0];",
              "if (c[0] == 1) x q[0];"]
    lines += [f"c[{i + 1}] = measure q[{i}];" for i in range(n)]
    return "\n".join(lines) + "\n"


def time_workloads(torch, T):
    """The timed workloads (chip_ab.py phase ``workloads``): the adjoint
    gradient on the default config at n=24, run_vqe's steps at n=20 and
    the n + s = 28 trajectory ensemble, each run as queued work under
    sync debug "error" and timed by the wall clock around it with a wait
    at each end.  Returns what phase 9 checks."""
    from gpu_quantum_simulator_tpu_torch import dynamic as Y
    from gpu_quantum_simulator_tpu_torch import gradients as G

    out = {}
    # the adjoint gradient, n = 24, default config
    n = WIDE_GRAD_WIDTH
    c, tie, terms = T.models.qaoa_maxcut_tied(n, **QAOA_ANGLES)
    sim = T.Simulator(device="cuda")
    G.adjoint_gradient(c, terms=terms)            # plan, tables, warm-up
    fresh_peak(torch)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    grads, idxs = G.adjoint_gradient(c, terms=terms)
    t_adj = time.perf_counter() - t0
    peak = peak_gib(torch)
    t0 = time.perf_counter()
    with no_wait(torch):
        re, im, _ = sim._run_device(c)
        queued = G._adjoint_sweep(c, terms, re, im, idxs)
    t_queue = time.perf_counter() - t0
    del re, im
    again = queued.double().cpu().numpy()
    print(f"workloads adjoint_gradient n={n} default config ({len(c)} "
          f"gates, {len(idxs)} parameters): {t_adj:.4f} s, peak reserved "
          f"{peak:.3f} GiB ({base / 2 ** 30:.3f} GiB allocated before); "
          f"forward + sweep queued under sync debug \"error\" in "
          f"{t_queue:.4f} s, max|diff| to the timed call "
          f"{float(np.max(np.abs(again - grads))):.3e}")
    out["adjoint"] = (c, tie, terms, grads, idxs, again)

    # run_vqe's loop, n = 20
    n = VQE_WIDTH
    c, tie, terms = T.models.qaoa_maxcut_tied(n, **QAOA_ANGLES)
    fn, _, th0 = G.make_adjoint_value_and_grad(c, terms, tie=tie)
    e0 = float(fn(th0)[0])
    G._vqe_device(c, terms, 1, 0.05, None, tie, True, None, 0, 0.5, 0,
                  "cuda")                         # warm-up
    fresh_peak(torch)
    t0 = time.perf_counter()
    with no_wait(torch):
        _, theta, es = G._vqe_device(c, terms, VQE_STEPS, 0.05, None, tie,
                                     True, None, 0, 0.5, 0, "cuda")
    t_queue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_vqe = time.perf_counter() - t0
    es = es.cpu().numpy()
    print(f"workloads run_vqe n={n} ({len(c)} gates, {len(th0)} slots): "
          f"{VQE_STEPS} steps queued under sync debug \"error\" in "
          f"{t_queue:.4f} s, done in {t_vqe:.4f} s = "
          f"{1e3 * t_vqe / VQE_STEPS:.2f} ms a step; peak reserved "
          f"{peak_gib(torch):.3f} GiB; <C> {es[0]:.6f} -> {es[-1]:.6f}")
    out["vqe"] = (e0, es)

    # the trajectory ensemble, n + s = 28, default config
    dc = T.parse_qasm_dynamic(ghz_dynamic_qasm(ENSEMBLE_N))
    s = (ENSEMBLE_SHOTS - 1).bit_length()
    sim = T.Simulator(device="cuda")
    Y._run_ensemble(dc, sim, s, 1)                # plans, warm-up
    fresh_peak(torch)
    t0 = time.perf_counter()
    with no_wait(torch):
        re, im, clbits, S = Y._run_ensemble(dc, sim, s, 2)
    t_queue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_ens = time.perf_counter() - t0
    peak = peak_gib(torch)
    norms = (re * re + im * im).view(S, -1).sum(1).double().cpu().numpy()
    bits = torch.stack(clbits).cpu().numpy()
    del re, im
    print(f"workloads ensemble n={ENSEMBLE_N} + s={s} (GHZ, mid-circuit "
          f"measure, reset, condition, {ENSEMBLE_N} measures): queued under "
          f"sync debug \"error\" in {t_queue:.4f} s, done in {t_ens:.4f} s; "
          f"peak reserved {peak:.3f} GiB")
    out["ensemble"] = (norms, bits)

    # the share of the segment copies: a per-gate noisy ensemble (one
    # segment a gate) with the pair handed over, and copied as
    # run_device_parts does
    noisy = Y.with_noise(T.models.ghz(ENSEMBLE_N), p1=0.01, p2=0.02)
    times, peaks = {}, {}
    for copy in (False, True, False, True):
        fresh_peak(torch)
        t0 = time.perf_counter()
        r = Y._run_ensemble(noisy, sim, s, 3, copy_segments=copy)
        torch.cuda.synchronize()
        times.setdefault(copy, []).append(time.perf_counter() - t0)
        peaks[copy] = (peak_gib(torch),
                       torch.cuda.max_memory_allocated() / 2 ** 30)
        del r
    hand, copy = min(times[False]), min(times[True])
    print(f"workloads noisy ensemble n={ENSEMBLE_N} + s={s} "
          f"({len(noisy.items)} items, {ENSEMBLE_N} one-gate segments): "
          f"pair handed over {hand:.4f} s (peak reserved / allocated "
          f"{peaks[False][0]:.3f} / {peaks[False][1]:.3f} GiB), copied per "
          f"segment {copy:.4f} s ({peaks[True][0]:.3f} / "
          f"{peaks[True][1]:.3f} GiB; best of 2 each): copies "
          f"{100 * (copy - hand) / copy:.1f}% of the copying run")
    return out


def check_gradients(torch, T, add, timed):
    """Adjoint against parameter shift at n=20 on prefetch "highest"; the
    n=24 readings of time_workloads; value_and_grad against the adjoint
    under the same tie arithmetic; run_vqe's loop; restarts batched."""
    from gpu_quantum_simulator_tpu_torch import gradients as G

    n = GRAD_WIDTH
    c, tie, terms = T.models.qaoa_maxcut_tied(n, **QAOA_ANGLES)
    cfg = T.SimulatorConfig(strategy="prefetch", precision="highest")
    tied = sorted(tie)
    idxs = tied[::max(1, len(tied) // GRAD_GATES)][:GRAD_GATES]
    reset_counts()
    t0 = time.perf_counter()
    adj, _ = G.adjoint_gradient(c, terms=terms, config=cfg,
                                gate_indices=idxs)
    t_adj = time.perf_counter() - t0
    t0 = time.perf_counter()
    shift, _ = G.parameter_shift(
        c, config=cfg, gate_indices=idxs,
        expectation_fn=lambda cc: T.expectation_pauli_sum(cc, terms, cfg))
    t_shift = time.perf_counter() - t0
    add(launch_counts())
    err = float(np.max(np.abs(adj - shift)))
    print(f"workloads gradients n={n} prefetch highest: adjoint "
          f"{t_adj:.3f} s vs parameter shift {t_shift:.3f} s on gates "
          f"{idxs}: max|diff| {err:.3e} (bar {GRAD_TOL:g}); "
          f"|grad| up to {float(np.max(np.abs(shift))):.4f}")
    if not err <= GRAD_TOL:
        raise AssertionError(f"adjoint vs parameter shift: {err}")

    c, tie, terms, grads, idxs, again = timed["adjoint"]
    if not float(np.max(np.abs(again - grads))) <= 1e-6:
        raise AssertionError("the queued adjoint differs from the timed one")
    fn, tidx, th0 = G.make_adjoint_value_and_grad(c, terms, tie=tie)
    t0 = time.perf_counter()
    e, g = fn(th0)
    g = g.double().cpu().numpy()
    t_fn = time.perf_counter() - t0
    per_gate, _ = G.adjoint_gradient(c, terms=terms, gate_indices=tidx)
    want = np.zeros(len(th0))
    for k, gk in zip(tidx, per_gate):
        slot, scale = tie[k]
        want[slot] += scale * gk
    rel = float(np.max(np.abs(g - want)) / np.max(np.abs(want)))
    print(f"workloads value_and_grad n={c.num_qubits} tie ({len(tidx)} "
          f"gates, {len(th0)} slots): {t_fn:.4f} s, <C> {float(e):.6f}; "
          f"vs the adjoint on the default config (\"high\" forward, torch "
          f"ops at \"highest\" here) max|diff| / max|grad| {rel:.3e} (bar "
          f"{TIE_TOL:g})")
    if not rel <= TIE_TOL:
        raise AssertionError(f"value_and_grad vs adjoint: {rel}")

    e0, es = timed["vqe"]
    d0 = abs(float(es[0]) - e0)
    print(f"workloads run_vqe: energies[0] - fn(theta0) {d0:.3e}; final "
          f"cut {es[-1]:.6f} vs first {es[0]:.6f}")
    if not (d0 <= 1e-6 and es[-1] > es[0] and np.all(np.isfinite(es))):
        raise AssertionError(f"run_vqe: {d0}, {es[0]} -> {es[-1]}")

    n = RESTART_WIDTH
    c, tie, terms = T.models.qaoa_maxcut_tied(n, gammas=(0.2,),
                                              betas=(0.2,))
    g, b = np.meshgrid(np.linspace(0.1, 1.2, LANDSCAPE_SIDE),
                       np.linspace(0.1, 0.7, LANDSCAPE_SIDE), indexing="ij")
    grid = np.stack([g, b], -1).reshape(-1, 2)
    fn, _, _ = G.make_adjoint_value_and_grad(c, terms, tie=tie)
    G._landscape_device(c, terms, grid[:2], tie, None, 24, "cuda")
    t0 = time.perf_counter()
    with no_wait(torch):
        land = G._landscape_device(c, terms, grid, tie, None, 24, "cuda")
    t_queue = time.perf_counter() - t0
    land = land.double().cpu().numpy()
    t_land = time.perf_counter() - t0
    picks = (0, len(grid) // 2, len(grid) - 1)
    err = max(abs(land[k] - float(fn(grid[k])[0])) for k in picks)
    best = np.unravel_index(np.argmax(land), g.shape)
    print(f"workloads energy_landscape n={n}: {len(grid)} points in chunks "
          f"of {1 << (24 - n)}, queued under sync debug \"error\" in "
          f"{t_queue:.4f} s, done in {t_land:.4f} s; against fn at three "
          f"points max|diff| {err:.3e}; argmax (gamma, beta) = "
          f"({g[best]:.3f}, {b[best]:.3f})")
    if not err <= 1e-5:
        raise AssertionError(f"energy_landscape: {err}")
    reset_counts()
    t0 = time.perf_counter()
    _, theta, es = G._vqe_device(c, terms, RESTART_STEPS, 0.05, None, tie,
                                 True, None, RESTARTS, 0.5, 1, "cuda")
    es = es.cpu().numpy()
    t_batch = time.perf_counter() - t0
    _, single = G.run_vqe(c, terms, steps=RESTART_STEPS, tie=tie,
                          maximize=True)
    best_theta, best = G.run_vqe(c, terms, steps=RESTART_STEPS, tie=tie,
                                 maximize=True, restarts=RESTARTS, seed=1)
    add(launch_counts())
    d = float(np.max(np.abs(es[0] - single)))
    print(f"workloads run_vqe restarts={RESTARTS} n={n}: one batched "
          f"sweep of {RESTART_STEPS} steps {t_batch:.3f} s, final <C> per "
          f"restart {np.round(es[:, -1], 4).tolist()}, restart 0 vs the "
          f"single run max|diff| {d:.3e}; best kept {best[-1]:.6f}")
    if not (d <= 1e-4 and es.shape == (RESTARTS, RESTART_STEPS)
            and abs(best[-1] - es[:, -1]).min() <= 1e-4):
        raise AssertionError(f"restarts: {d}, {es.shape}")


def check_dynamic(torch, T, add, timed):
    """The n + s = 28 ensemble's bits and norms (time_workloads), the
    public batched run, the program caches, and run_dynamic on the card
    against the CPU with one seed."""
    from gpu_quantum_simulator_tpu_torch import dynamic as Y
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S
    from gpu_quantum_simulator_tpu_torch.engine import wide as W

    norms, bits = timed["ensemble"]
    shots = ENSEMBLE_SHOTS
    dev = float(np.max(np.abs(norms - 1.0)))
    same = bool(np.all(bits == bits[:1]))
    print(f"workloads ensemble (queued): {bits.shape[1]} shots x "
          f"{bits.shape[0]} bits, every shot's bits equal: {same}; "
          f"max|norm - 1| over shot blocks {dev:.3e} (bar "
          f"{ENSEMBLE_NORM_TOL:g})")
    if not (same and dev <= ENSEMBLE_NORM_TOL):
        raise AssertionError(f"ensemble: bits equal {same}, norm {dev}")
    dc = T.parse_qasm_dynamic(ghz_dynamic_qasm(ENSEMBLE_N))
    fresh_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    res = T.run_dynamic_batched(dc, shots=shots, seed=5)
    secs = time.perf_counter() - t0
    add(launch_counts())
    ones = sum(r.clbits[0] for r in res)
    same = all(len(set(r.clbits)) == 1 for r in res)
    sigma = (shots * 0.25) ** 0.5
    caches = {"mxu plans": len(S._MXU_PLAN_CACHE), "wide": len(W._CACHE),
              "prefetch": len(PF._PROGRAM_CACHE)}
    print(f"workloads run_dynamic_batched n={ENSEMBLE_N} shots={shots}: "
          f"{secs:.3f} s, {ones} ones (Binomial({shots}, 1/2) 4 sigma "
          f"{4 * sigma:.1f}), every shot's bits equal: {same}; program "
          f"caches {caches}; peak reserved {peak_gib(torch):.3f} GiB")
    if not (same and abs(ones - shots / 2) <= 4 * sigma):
        raise AssertionError(f"run_dynamic_batched: {ones}, {same}")

    dc = T.parse_qasm_dynamic(ghz_dynamic_qasm(PER_SHOT_N))
    reset_counts()
    t0 = time.perf_counter()
    card = T.run_dynamic(dc, shots=4, seed=11)
    secs = time.perf_counter() - t0
    add(launch_counts())
    host = T.run_dynamic(dc, shots=4, seed=11, device="cpu")
    cb, hb = [r.clbits for r in card], [r.clbits for r in host]
    print(f"workloads run_dynamic n={PER_SHOT_N} shots=4: {secs:.3f} s on "
          f"the card; bits {[b[0] for b in cb]} equal the CPU run's: "
          f"{cb == hb}")
    if cb != hb:
        raise AssertionError(f"run_dynamic card {cb} vs cpu {hb}")


def check_noise(torch, T, add):
    """expectation_noisy at p = 0 and against the density matrix; the
    noisy CLI route at n=20; one ZNE ladder at n=16."""
    import tempfile

    from gpu_quantum_simulator_tpu_torch import dynamic as Y

    c = T.models.qaoa_maxcut(GRAD_WIDTH)
    terms = [(1.0, "Z0 Z1"), (0.5, "X3"), (-0.7, "Y5 Z9")]
    reset_counts()
    got = Y.expectation_noisy(c, terms, shots=8, seed=0)
    add(launch_counts())
    want = T.expectation_pauli_sum(c, terms)
    err = abs(got - want)
    print(f"workloads expectation_noisy p=0 n={GRAD_WIDTH}: {got:.7f} vs "
          f"expectation_pauli_sum {want:.7f}: |diff| {err:.3e} (bar "
          f"{NOISELESS_TOL:g})")
    if not err <= NOISELESS_TOL:
        raise AssertionError(f"noiseless expectation_noisy: {err}")

    n, shots, p1, p2 = NOISE_N, NOISE_SHOTS, 0.02, 0.05
    c = T.models.qaoa_maxcut(n)
    nc = T.NoisyCircuit(n)
    for item in Y.with_noise(c, p1=p1, p2=p2).items:
        if isinstance(item, Y.Noise):
            nc.channel("depolarizing", item.qubit, p=item.p)
        else:
            nc.items.append(item)
    rho = T.DensitySimulator().run(nc)
    m = rho.matrix()
    idx = np.arange(1 << n)
    exact = {"Z0 Z1": rho.expectation_z([0, 1]),
             "X0 X1": float(np.real(np.sum(m[idx ^ 3, idx])))}
    for pauli, want in exact.items():
        reset_counts()
        t0 = time.perf_counter()
        got = Y.expectation_noisy(c, [(1.0, pauli)], shots=shots, p1=p1,
                                  p2=p2, seed=7)
        secs = time.perf_counter() - t0
        add(launch_counts())
        sigma = ((1 - want ** 2) / shots) ** 0.5
        print(f"workloads expectation_noisy n={n} {shots} shots <{pauli}>: "
              f"{got:.5f} in {secs:.3f} s vs the density matrix {want:.5f} "
              f"({(got - want) / sigma:+.2f} sigma)")
        if not abs(got - want) <= 4 * sigma:
            raise AssertionError(f"expectation_noisy {pauli}: {got} {want}")

    with tempfile.TemporaryDirectory() as tmp:
        path = qasm_file(tmp, "ghz20", T.models.ghz(GRAD_WIDTH))
        reset_counts()
        wall, lines = cli(path, "-m", 1024, "--noise-p1", 0.01,
                          "--noise-p2", 0.02, "--noise-readout", 0.01,
                          "--json")
        add(launch_counts())
    rec = json.loads(lines[0])
    meas = [l for l in lines[1:] if l.startswith("MEASUREMENT:")]
    print(f"workloads CLI noisy sampling n={GRAD_WIDTH} -m 1024: exit 0, "
          f"{len(meas)} outcomes, CLI seconds {rec['seconds']:.3f}, main() "
          f"{wall:.3f} s")
    if len(meas) != 1024:
        raise AssertionError(f"noisy CLI: {len(meas)} outcomes")

    c = T.models.ghz(ZNE_N)
    reset_counts()
    t0 = time.perf_counter()
    value, scales, raw = T.zne_expectation(
        c, [(1.0, f"Z0 Z{ZNE_N - 1}")], shots=1024, p1=0.01, p2=0.01,
        seed=3, return_fits=True)
    secs = time.perf_counter() - t0
    add(launch_counts())
    print(f"workloads zne_expectation n={ZNE_N} <Z0 Z{ZNE_N - 1}>: raw "
          f"{[round(v, 4) for v in raw]} at scales {scales} -> {value:.4f} "
          f"(exact 1) in {secs:.3f} s")
    if not (np.isfinite(value) and raw[0] > raw[-1]):
        raise AssertionError(f"zne: {value} {raw}")


def check_density(torch, T, add):
    """2n = 24 on prefetch at "high" (channels: trace; none: the diagonal
    against |psi|^2), and once in place at 2n = 30."""
    n = DENSITY_N
    c = T.models.random_circuit(n, 120, seed=5)
    pure = T.NoisyCircuit(n, items=list(c.gates))
    noisy = T.NoisyCircuit(n, items=list(c.gates[:60]))
    noisy.channel("depolarizing", 3, p=0.2)
    noisy.channel("amplitude_damping", 7, gamma=0.3)
    noisy.items.extend(c.gates[60:])
    noisy.channel("depolarizing", 11, p=0.1)
    sim = T.DensitySimulator()
    clear_caches(torch)
    fresh_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    p = sim.run(noisy).probabilities()
    secs = time.perf_counter() - t0
    q = sim.run(pure).probabilities()
    add(launch_counts())
    psi = np.abs(T.Simulator().run(c)) ** 2
    trace = float(np.sum(p.astype(np.float64)))
    bar = HIGH_TOL * max(1.0, float(psi.max()) / HIGH_BAR_PEAK)
    err = float(np.max(np.abs(q - psi)))
    print(f"workloads density n={n} (2n={2 * n}, prefetch "
          f"{T.SimulatorConfig().effective_precision(2 * n)}): {secs:.3f} s "
          f"with channels, trace {trace:.8f} (bar {TRACE_TOL:g}); without, "
          f"max|diag - |psi|^2| {err:.3e} (bar {bar:.3e}); peak reserved "
          f"{peak_gib(torch):.3f} GiB")
    if not (abs(trace - 1) <= TRACE_TOL and err <= bar):
        raise AssertionError(f"density n={n}: trace {trace}, diag {err}")

    n = DENSITY_INPLACE_N
    nc = T.NoisyCircuit(n, items=list(T.models.ghz(n).gates))
    for qb in range(n):
        nc.channel("dephasing", qb, p=0.3)
    clear_caches(torch)
    fresh_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    res = sim.run(nc)
    secs = time.perf_counter() - t0
    add(launch_counts())
    p = res.probabilities()
    trace = float(np.sum(p.astype(np.float64)))
    print(f"workloads density n={n} in place (2n={2 * n}, halves "
          f"{res.halves is not None}): {secs:.3f} s, P(0..0) {p[0]:.7f}, "
          f"P(1..1) {p[-1]:.7f}, trace {trace:.7f} (bars {TRACE_TOL:g}); "
          f"peak reserved {peak_gib(torch):.3f} GiB")
    if not (res.halves is not None and abs(p[0] - 0.5) <= TRACE_TOL
            and abs(p[-1] - 0.5) <= TRACE_TOL
            and abs(trace - 1) <= TRACE_TOL):
        raise AssertionError(f"density n={n}: {p[0]} {p[-1]} {trace}")
    del res
    clear_caches(torch)


def check_shadows(torch, T, add):
    """Z0 Z1 of GHZ-20 from 4000 snapshots, within 5 standard errors of 1
    (the error from the snapshots' own spread)."""
    n, S = SHADOW_N, SHADOW_SNAPSHOTS
    c = T.models.ghz(n)
    reset_counts()
    t0 = time.perf_counter()
    bases, outcomes = T.shadow_snapshots(c, S, seed=4)
    secs = time.perf_counter() - t0
    add(launch_counts())
    est = T.shadows_expectation(c, [(1.0, "Z0 Z1")],
                                _snapshot_data=(bases, outcomes))
    single = np.where((bases[:, 0] == 2) & (bases[:, 1] == 2),
                      9.0 * (1 - 2 * (((outcomes >> 0) ^ (outcomes >> 1))
                                      & 1)), 0.0)
    se = float(single.std() / np.sqrt(S))
    print(f"workloads shadows n={n}: {S} snapshots in {secs:.3f} s; "
          f"<Z0 Z1> {est:.4f} (mean of the snapshots {single.mean():.4f}, "
          f"standard error {se:.4f}, bar 5 se about 1)")
    if not abs(est - 1.0) <= 5 * se:
        raise AssertionError(f"shadows: {est} +- {se}")


def run_workloads(torch, T, add):
    """Phase 9: the workloads on the state, through the ported entry
    points on the card; their launches add to the totals."""
    t0 = time.perf_counter()
    clear_caches(torch)
    reset_counts()
    timed = time_workloads(torch, T)
    add(launch_counts())
    check_gradients(torch, T, add, timed)
    check_dynamic(torch, T, add, timed)
    del timed
    clear_caches(torch)
    check_noise(torch, T, add)
    check_density(torch, T, add)
    check_shadows(torch, T, add)
    clear_caches(torch)
    print(f"workloads: phase 9 in {time.perf_counter() - t0:.1f} s")


# ----------------------------- phase 10: the "default" rung and complex128
DEFAULT_TOL = 1e-6          # a "default" kernel against its plain version,
                            # of the output's largest |value|: the same exact
                            # one-pass products, fp32 sums in another order
DEFAULT_MAT_WIDTHS = ((24, 20), (28, 3))    # (n, timing reps), kernel 3'
DEFAULT_SPLIT_WIDTHS = ((24, 10), (30, 3))  # (n, timing reps), kernel 5
DEFAULT_REF_WIDTH = 18      # grover_like(18, 2445, 318) at "default" vs f64
DEFAULT_BAR = 1e-3          # its error bar against f64 (the JAX package
                            # measured 2.7e-4 there on a TPU,
                            # docs/PERFORMANCE.md), and RUNG_FLOOR below it
RUNG_FLOOR = 1e-6           # shows that the rounding ran
KARATSUBA_BAR = 2e-3        # mxu's one Karatsuba pass, per unit of peak
                            # |amplitude| / HIGH_BAR_PEAK
                            # (tests/test_torch_default.py)
DEFAULT_FLAT = 24           # "default" through prefetch flat (and mxu)
C128_WIDTHS = (20, 24)      # complex128 mxu and megakernel, timed; n=20
                            # held to the f64 reference
C128_TOL = 1e-9             # tests/test_engines.py:69-74
MAT_DEFAULT_SRC = HIGH_SRC + " (mat_high_kernel<false>)"
SPLIT_DEFAULT_SRC = SPLIT_SRC + " (mat_high_halves_kernel<false>)"
CHAIN_DEFAULT_SRC = WIDE_SRC + " (chain_high_kernel<false>, its own body)"
MM_DEFAULT_SRC = MM_SRC + " (mm_high_kernel<D, false>)"


def exact_values(torch, gen, shape, top, scale):
    """bf16-exact float32 values on the card: integers in [-top, top]
    times ``scale`` (a sum of two states' values, top <= 64, stays
    bf16-exact)."""
    return torch.randint(-top, top + 1, shape, generator=gen,
                         device="cuda").float() * scale


def rel_diff(got, want):
    return max_diff(got, want) / max(float(w.abs().max()) for w in want)


def same(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def one_pass_library(torch, xr, xi, mr, mi):
    """One PyTorch call computing a "default" complex product, the
    yardstick of its kernel: ``torch.mm`` of bf16 [xr | xi] and the bf16
    real form [[mr, mi], [-mi, mr]] of the matrix, fp32 sums and output
    (operands built here, outside the timed call).  Returns the timed
    callable and its (re, im) result."""
    x = torch.cat([xr, xi], 1).to(torch.bfloat16)
    w = torch.cat([torch.cat([mr, mi], 1), torch.cat([-mi, mr], 1)],
                  0).to(torch.bfloat16)
    cols = mr.shape[1]

    def call():
        return torch.mm(x, w, out_dtype=torch.float32)

    out = call()
    return call, (out[:, :cols], out[:, cols:])


def check_default_mat(torch):
    """Kernels 3' and 5 at "default" (the "high" body's second
    instantiation): against the plain version at n=24 and 28 flat, 24 in
    place (and bit for bit the flat step there), bit for bit the "high"
    arm on bf16-exact state and tables, each timed beside the "high" arm,
    the plain version, one bf16 torch.mm and the bound; in place also at
    n=30.  Draws come from seeds of their own."""
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.kernels.block import (
        run_block, run_block_plain, split_tables)
    from gpu_quantum_simulator_tpu_torch.kernels.split import (
        run_split_block, run_split_block_plain, split_halves)

    rng = np.random.default_rng(1010)
    gen = torch.Generator(device="cuda").manual_seed(1010)
    blk = PF._Block(kinds=[0], midx=[0],
                    mats=[(random_unitary(rng, 128), tuple(range(7)), None)])
    scal, a_tab, b_tab, mono_src = device_tables(torch, PF, [blk], 2)
    w = split_tables(a_tab, b_tab)
    ea, eb = (exact_values(torch, gen, a_tab[0].shape, 16, 2.0 ** -6)
              for _ in range(2))
    ew = split_tables(ea, eb)
    recs = {}

    def args(n, exact=False):
        logt = int(np.log2(PF.tile_rows(n)))
        return ((ea, eb) if exact else (a_tab[0], b_tab[0])) + (
            mono_src[0], logt, PF.CAP_STEPS)

    for n, reps in DEFAULT_MAT_WIDTHS:
        R2 = 1 << (n - PF.LOCAL_QUBITS)
        re, im = (torch.randn(R2, 256, device="cuda", generator=gen) / 16
                  for _ in range(2))
        scratch = (torch.empty_like(re), torch.empty_like(im))
        got = run_block(scal[0], re.clone(), im.clone(), *args(n),
                        scratch=scratch, precision="default",
                        high_tables=w[0])
        want = run_block_plain(scal[0], re, im, *args(n), precision="default")
        lib_call, lib = one_pass_library(torch, re, im, a_tab[0, 0],
                                         b_tab[0, 0])
        torch.cuda.synchronize()
        e, e_lib = rel_diff(got, want), rel_diff(lib, want)
        if not e <= DEFAULT_TOL:
            raise AssertionError(f"default mat step n={n}: {e} > "
                                 f"{DEFAULT_TOL}")
        del got, want, lib
        timed = {rung: device_ms(torch, lambda rung=rung: run_block(
            scal[0], re, im, *args(n), scratch=scratch, precision=rung,
            high_tables=w[0]), reps=reps) for rung in ("default", "high")}
        plain_ms = device_ms(torch, lambda: run_block_plain(
            scal[0], re, im, *args(n), precision="default"), reps=3)
        library_ms = device_ms(torch, lib_call, reps=reps)
        flop = 6.0 * R2 * 256 * 256      # three real products, one pass
        bnd = bound(flop, 16.0 * R2 * 256 + 2 * 256 * 256 * 2, BF16_FLOPS)
        exact = ""
        if n == DEFAULT_MAT_WIDTHS[0][0]:
            xe = [exact_values(torch, gen, (R2, 256), 64, 2.0 ** -7)
                  for _ in range(2)]
            d, h = (run_block(scal[0], xe[0].clone(), xe[1].clone(),
                              *args(n, True), precision=rung,
                              high_tables=ew)
                    for rung in ("default", "high"))
            if not same(torch, d, h):
                raise AssertionError("default mat step: not the 'high' arm "
                                     "bit for bit on bf16-exact operands")
            exact = "; bit for bit the 'high' arm on bf16-exact operands"
            recs["flat"] = record("mat_step_default", MAT_DEFAULT_SRC,
                                  STREAM_TPU, e, timed["default"], plain_ms,
                                  bnd, library_ms)
            del xe, d, h
        print(f"default mat step n={n}: max|diff| vs plain {e:.3e} of the "
              f"largest |value| (one bf16 torch.mm {e_lib:.3e}){exact}; "
              f"kernel {timed['default']:.4f} ms (before "
              f"{BEFORE_MS[f'default mat step n={n} (flat)']} ms), 'high' arm "
              f"{timed['high']:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"(bf16 torch.mm, fp32 out) {library_ms:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]})")
        del re, im, scratch
        torch.cuda.empty_cache()

    for n, reps in DEFAULT_SPLIT_WIDTHS:
        R2 = 1 << (n - PF.LOCAL_QUBITS)
        h4 = tuple(torch.randn(R2, 128, device="cuda", generator=gen) / 16
                   for _ in range(4))
        checked = ""
        if n == DEFAULT_SPLIT_WIDTHS[0][0]:
            got = run_split_block(scal[0], clone4(h4), *args(n),
                                  precision="default", high_tables=w[0])
            want = run_split_block_plain(scal[0], clone4(h4), *args(n),
                                         precision="default")
            flat = run_block(scal[0], *joined(torch, h4), *args(n),
                             precision="default", high_tables=w[0])
            lib_call, lib = one_pass_library(
                torch, *joined(torch, h4), a_tab[0, 0], b_tab[0, 0])
            torch.cuda.synchronize()
            jw = joined(torch, want)
            e = rel_diff(joined(torch, got), jw)
            e_flat = max_diff(joined(torch, got), flat)
            e_lib = rel_diff(lib, jw)
            if not (e <= DEFAULT_TOL and e_flat == 0.0):
                raise AssertionError(f"default split mat step n={n}: {e}, "
                                     f"vs flat {e_flat}")
            xe = [exact_values(torch, gen, (R2, 256), 64, 2.0 ** -7)
                  for _ in range(2)]
            he = (*split_halves(xe[0]), *split_halves(xe[1]))
            d, h = (run_split_block(scal[0], clone4(he), *args(n, True),
                                    precision=rung, high_tables=ew)
                    for rung in ("default", "high"))
            if not same(torch, d, h):
                raise AssertionError("default split mat step: not the "
                                     "'high' arm bit for bit on bf16-exact "
                                     "operands")
            plain_ms = device_ms(torch, lambda: run_split_block_plain(
                scal[0], h4, *args(n), precision="default"), reps=3)
            library_ms = device_ms(torch, lib_call, reps=reps)
            checked = (f"max|diff| vs plain {e:.3e} of the largest |value| "
                       f"(one bf16 torch.mm {e_lib:.3e}), vs the flat step "
                       f"{e_flat:.1e}; bit for bit the 'high' arm on "
                       f"bf16-exact operands; plain {plain_ms:.4f} ms, "
                       f"library {library_ms:.4f} ms; ")
            del got, want, flat, lib, jw, xe, he, d, h
        timed = {rung: device_ms(torch, lambda rung=rung: run_split_block(
            scal[0], h4, *args(n), precision=rung, high_tables=w[0]),
            reps=reps, rounds=3 if n == 30 else 5)
            for rung in ("default", "high")}
        bnd = bound(6.0 * R2 * 256 * 256,
                    16.0 * R2 * 256 + 2 * 256 * 256 * 2, BF16_FLOPS)
        before = BEFORE_MS[f"default mat step n={n} (in place)"]
        print(f"default split mat step n={n} in place: {checked}kernel "
              f"{timed['default']:.4f} ms (before {before} ms), 'high' arm "
              f"{timed['high']:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if n == DEFAULT_SPLIT_WIDTHS[0][0]:
            recs["split"] = record("split_mat_step_default",
                                   SPLIT_DEFAULT_SRC, SPLIT_TPU, e,
                                   timed["default"], plain_ms, bnd,
                                   library_ms)
        del h4
        torch.cuda.empty_cache()
    return recs["flat"], recs["split"]


def check_default_chain(torch):
    """Kernel 7 at "default" at n=24, on its hi-only tables
    (``kh0_high_tables(tables, "default")``, the full image's hi parts; the
    full image raises): a P = 1 chain against its plain version and bit for
    bit the D = 128 "default" mm step; a P = 8 chain bit for bit eight
    P = 1 launches (a product's results become the next product's bf16
    fragments as a launch rounds its input), each of which holds to the
    plain version on its own input (one bf16 pass is discontinuous: an ulp
    of a product's input may move its rounding by 2^-9, so a chain is held
    product by product); P = 1 bit for bit the "high" arm on bf16-exact
    operands; timed at P = 1 and 8 beside the "high" arm, the plain
    version and the library: one bf16 torch.mm of the real form a product
    (eight in a row at P = 8, each on operands of its own)."""
    from gpu_quantum_simulator_tpu_torch.engine.wide import KH0_BATCH
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW

    n = WIDE_WIDTH
    R = 1 << (n - 7)
    rng = np.random.default_rng(1011)
    gen = torch.Generator(device="cuda").manual_seed(1011)
    re, im = random_state(torch, gen, (R, 128))
    us = [random_unitary(rng, 128) for _ in range(KH0_BATCH)]
    tabs = torch.tensor(np.stack([np.stack([u.real, u.imag]) for u in us]),
                        dtype=torch.float32, device="cuda")
    w16 = KW.kh0_high_tables(tabs)
    wd = KW.kh0_high_tables(tabs, "default")
    if not (wd.shape == (KH0_BATCH, 3 * 128 * 128)
            and torch.equal(wd, KW.mm_hi_image(w16))):
        raise AssertionError("default chain: the hi-only image is not the "
                             "full image's hi parts")
    try:
        KW.kh0_chain(re, im, tabs[:1], "default", w16=w16[:1])
        raise AssertionError("default chain: took the full image")
    except ValueError:
        pass
    one = KW.kh0_chain(re, im, tabs[:1], "default", w16=wd[:1])
    step = KW.mm_step_default(re, im, wd[0], ())
    whole = KW.kh0_chain(re, im, tabs, "default", w16=wd)
    x, err = (re, im), 0.0
    for j in range(KH0_BATCH):
        y = KW.kh0_chain(*x, tabs[j : j + 1], "default", w16=wd[j : j + 1])
        err = max(err, rel_diff(y, KW.kh0_chain_plain(
            *x, tabs[j : j + 1], "default", w16=wd[j : j + 1])))
        x = y
    lib_calls, lib = [], None
    for j in range(KH0_BATCH):
        mr, mi = tabs[j, 0].T.contiguous(), tabs[j, 1].T.contiguous()
        call, res = one_pass_library(torch, re, im, mr, mi)
        lib_calls.append(call)
        lib = res if lib is None else lib
    se = [exact_values(torch, gen, (R, 128), 64, 2.0 ** -7) for _ in range(2)]
    te = exact_values(torch, gen, (1, 2, 128, 128), 16, 2.0 ** -6)
    ed, eh = (KW.kh0_chain(*se, te, rung,
                           w16=KW.kh0_high_tables(te, rung))
              for rung in ("default", "high"))
    torch.cuda.synchronize()
    e_lib = rel_diff(lib, one)
    checks = {"P=1 vs the D=128 mm step": same(torch, one, step),
              "P=8 vs eight P=1 launches": same(torch, whole, x),
              "'high' arm on bf16-exact operands": same(torch, ed, eh)}
    print(f"default chain n={n}: hi-only tables; each product vs plain "
          f"max|diff| {err:.3e} of the largest |value| (one bf16 torch.mm "
          f"{e_lib:.3e}); bit for bit: {checks}")
    if not (err <= DEFAULT_TOL and all(checks.values())):
        raise AssertionError(f"default chain: {err}, {checks}")
    del one, step, whole, x, y, se, te, ed, eh, lib
    rec = None
    for P in (1, KH0_BATCH):
        out = (torch.empty_like(re), torch.empty_like(im))
        images = {"default": wd, "high": w16}
        timed = {rung: device_ms(torch, lambda rung=rung: KW.kh0_chain(
            re, im, tabs[:P], rung, out=out, w16=images[rung][:P]), reps=10)
            for rung in ("default", "high")}
        plain_ms = device_ms(torch, lambda: KW.kh0_chain_plain(
            re, im, tabs[:P], "default", w16=wd[:P]), reps=3)

        def library(P=P):
            for call in lib_calls[:P]:
                call()

        library_ms = device_ms(torch, library, reps=10)
        flop = 6.0 * R * 128 * 128 * P
        bnd = bound(flop, 16.0 * R * 128 + P * 3 * 128 * 128 * 2, BF16_FLOPS)
        before = BEFORE_MS[f"default chain n={n} P={P}"]
        print(f"default chain n={n} P={P}: kernel {timed['default']:.4f} ms "
              f"({flop / timed['default'] / 1e9:.1f} bf16 TFLOP/s; before "
              f"{before} ms), 'high' arm {timed['high']:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library ({P} bf16 torch.mm, fp32 out) "
              f"{library_ms:.4f} ms ({timed['default'] / library_ms:.2f}x), "
              f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if P == KH0_BATCH:
            rec = record("wide_chain_kh0_default", CHAIN_DEFAULT_SRC,
                         KH0_TPU, err, timed["default"], plain_ms, bnd,
                         library_ms)
        del out
    del re, im, lib_calls
    torch.cuda.empty_cache()
    return rec


def check_default_mm(torch):
    """mxu's "default" mm step at n=24, D = 512 and 256, through the row
    map: against its plain version, bit for bit the "high" arm on
    bf16-exact operands, timed beside the "high" arm, the plain version
    and one bf16 torch.mm on the row-shuffled state (the shuffle outside
    the timed call)."""
    from gpu_quantum_simulator_tpu_torch.kernels import wide as KW

    n = WIDE_WIDTH
    R = 1 << (n - 7)
    rng = np.random.default_rng(1012)
    gen = torch.Generator(device="cuda").manual_seed(1012)
    re, im = random_state(torch, gen, (R, 128))
    rec = None
    for row_bits in MM_ROW_BITS:
        D = 128 << len(row_bits)
        M = (1 << n) // D
        m32 = mm_unitary_tables(torch, rng, D, 1)[0]
        # each rung's image: the hi parts alone at "default"
        w16 = {"default": KW.split_mm_tables_hi(m32),
               "high": KW.split_mm_tables(m32)}
        got = KW.mm_step_default(re, im, w16["default"], row_bits)
        want = KW.mm_step_default_plain(re, im, w16["default"], row_bits)
        fwd, bwd = KW.row_shuffles(row_bits, R)
        lib_call, lib = one_pass_library(torch, fwd(re), fwd(im), m32[0],
                                         m32[0] + m32[1])
        se = [exact_values(torch, gen, (R, 128), 64, 2.0 ** -7)
              for _ in range(2)]
        me = exact_values(torch, gen, (3, D, D), 16, 2.0 ** -6)
        ed = KW.mm_step_default(*se, KW.split_mm_tables_hi(me), row_bits)
        eh = KW.mm_step_high(*se, KW.split_mm_tables(me), row_bits)
        torch.cuda.synchronize()
        e = rel_diff(got, want)
        e_lib = rel_diff(tuple(bwd(t) for t in lib), want)
        exact = same(torch, ed, eh)
        if not (e <= DEFAULT_TOL and exact):
            raise AssertionError(f"default mm step D={D}: {e}, bit for bit "
                                 f"the 'high' arm on bf16-exact operands "
                                 f"{exact}")
        del got, want, lib, se, me, ed, eh
        out = (torch.empty_like(re), torch.empty_like(im))
        step = {"default": KW.mm_step_default, "high": KW.mm_step_high}
        timed = {rung: device_ms(torch, lambda rung=rung: step[rung](
            re, im, w16[rung], row_bits, out=out), reps=10)
            for rung in ("default", "high")}
        plain_ms = device_ms(torch, lambda: KW.mm_step_default_plain(
            re, im, w16["default"], row_bits), reps=3)
        library_ms = device_ms(torch, lib_call, reps=10)
        flop = 6.0 * M * D * D           # three real products, one pass
        bnd = bound(flop, 16.0 * M * D + 3 * D * D * 2, BF16_FLOPS)
        before = BEFORE_MS[f"default mm step n={n} D={D}"]
        print(f"default mm step n={n} D={D} row bits {row_bits}: max|diff| "
              f"vs plain {e:.3e} of the largest |value| (one bf16 torch.mm "
              f"{e_lib:.3e}); bit for bit the 'high' arm on bf16-exact "
              f"operands; kernel {timed['default']:.4f} ms (before {before} "
              f"ms), 'high' arm "
              f"{timed['high']:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"(bf16 torch.mm on the shuffled rows, fp32 out) "
              f"{library_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if rec is None:
            rec = record("mm_step_default", MM_DEFAULT_SRC, MM_TPU, e,
                         timed["default"], plain_ms, bnd, library_ms)
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        del out, w16, m32
    del re, im
    torch.cuda.empty_cache()
    return rec


def run_default_paths(torch, T, refs, highest24, add):
    """The "default" rung through the Simulator, counts set to 0 before
    each run and read after: prefetch flat at n=18 against the f64
    reference (in (RUNG_FLOOR, DEFAULT_BAR]) and at n=24 against the
    port's "highest" state, in place at n=30 (norm and peak memory), and
    mxu at n=24 on the benchmark circuit (mm steps) and the low-only
    circuit (chains of 8), launches against the plans."""
    from gpu_quantum_simulator_tpu_torch import sampling as SP
    from gpu_quantum_simulator_tpu_torch.engine import prefetch as PF
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S

    def cfg(**kw):
        return T.Simulator(T.SimulatorConfig(precision="default", **kw),
                           device="cuda")

    prefetch = cfg(strategy="prefetch")
    for n, runs in ((DEFAULT_REF_WIDTH, 2), (DEFAULT_FLAT, 1)):
        c = T.models.grover_like(n, 2445, 318)
        res, secs, counts, modes = drive(torch, PF, prefetch, c, runs)
        add(counts)
        want = refs[n] if n == DEFAULT_REF_WIDTH else highest24
        err = float(np.max(np.abs(res.state - want)))
        norm = float(np.linalg.norm(res.state))
        report(n, res, secs, counts, f"prefetch 'default'; max|amp - "
               f"{'f64' if n == DEFAULT_REF_WIDTH else 'its highest run'}| "
               f"{err:.3e}; norm {norm:.8f}")
        check_counts(n, counts, modes, runs + 1, False, default=True)
        if not RUNG_FLOOR < err <= DEFAULT_BAR:
            raise AssertionError(f"prefetch default n={n}: {err} outside "
                                 f"({RUNG_FLOOR}, {DEFAULT_BAR}]")
        del res

    n = FULL_WIDTH
    gib = float(1 << 30)
    clear_caches(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    parts, nops = prefetch.run_device_halves(T.models.grover_like(n, 2445,
                                                                  318))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    add(counts)
    (prog,) = PF._RUN_CACHE.values()
    modes = dict(prog.mode_rows)
    norm = SP.norm_halves(*parts)
    print(f"prefetch 'default' n={n} in place: {nops} steps; first run "
          f"{secs:.2f} s (fusion, plan and tables included); norm_halves "
          f"{norm:.8f}; peak device memory {peak / gib:.3f} GiB; launches "
          f"{counts}")
    check_inplace_counts(n, counts, modes, 1, False, default=True)
    if not np.isfinite(norm):
        raise AssertionError(f"prefetch default n={n}: norm {norm}")
    del parts
    clear_caches(torch)

    def mxu(**kw):
        return cfg(strategy="mxu", **kw)

    def program():
        (_, prog), = S._MXU_PLAN_CACHE.values()
        steps = [st for seg in prog.segments for st in seg.steps]
        return prog, sum(st[0] == "mm" for st in steps)

    n = DEFAULT_FLAT
    res, secs, counts = drive_engine(
        torch, mxu(), T.models.grover_like(n, 2445, 318), 1,
        S._MXU_PLAN_CACHE)
    add(counts)
    prog, mm = program()
    err = float(np.max(np.abs(res.state - highest24)))
    bar = KARATSUBA_BAR * max(1.0, float(np.max(np.abs(highest24)))
                              / HIGH_BAR_PEAK)
    report(n, res, secs, counts, f"mxu 'default'; vs prefetch's 'highest' "
           f"{err:.3e} (bar {bar:.3e}); mm steps {mm}")
    check_only(n, counts, 2, kh0_default=prog.num_kh0_runs, mm_default=mm)
    if not RUNG_FLOOR < err <= bar:
        raise AssertionError(f"mxu default n={n}: {err}")
    n, gates, seed = LOW_ONLY
    c = low_only(T, n, gates, seed)
    res, secs, counts = drive_engine(torch, mxu(max_fused_qubits=3), c, 1,
                                     S._MXU_PLAN_CACHE)
    add(counts)
    prog, mm = program()
    ref = T.Simulator(T.SimulatorConfig(strategy="mxu", precision="highest",
                                        max_fused_qubits=3),
                      device="cuda").run(c)
    err = float(np.max(np.abs(res.state - ref)))
    bar = KARATSUBA_BAR * max(1.0, float(np.max(np.abs(ref))) / HIGH_BAR_PEAK)
    report(n, res, secs, counts, f"mxu 'default' low-only max_fused_qubits"
           f"=3: vs its 'highest' run {err:.3e} (bar {bar:.3e}); kh0 runs "
           f"{prog.num_kh0_runs}")
    check_only(n, counts, 2, kh0_default=prog.num_kh0_runs, mm_default=mm)
    if not (prog.num_kh0_runs == 9 and RUNG_FLOOR < err <= bar):
        raise AssertionError(f"mxu default low-only: {err}, "
                             f"{prog.num_kh0_runs} kh0 runs")
    clear_caches(torch)


def run_complex128(torch, T, refs):
    """complex128 through mxu and the megakernel (float64 torch ops, no
    hand kernel: no launch is counted) at n=20 and 24: the second run
    timed, peak device memory, a complex128 result; n=20 within
    C128_TOL of the f64 reference, and at n=24 the two arms within it of
    each other."""
    states = {}
    gib = float(1 << 30)
    for n in C128_WIDTHS:
        c = T.models.grover_like(n, 2445, 318)
        for strategy in ("mxu", "megakernel"):
            sim = T.Simulator(T.SimulatorConfig(strategy=strategy,
                                                dtype="complex128"),
                              device="cuda")
            clear_caches(torch)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            first = sim.run_detailed(c)
            res = sim.run_detailed(c)
            peak = torch.cuda.max_memory_allocated()
            counts = launch_counts()
            line = (f"complex128 {strategy} n={n}: {res.num_fused_ops} ops; "
                    f"first run {first.seconds:.4f} s, second "
                    f"{res.seconds:.4f} s; peak device memory "
                    f"{peak / gib:.3f} GiB; dtype {res.state.dtype}")
            if n in refs:
                err = float(np.max(np.abs(res.state - refs[n])))
                line += f"; max|amp - f64| {err:.3e}"
                if not err <= C128_TOL:
                    raise AssertionError(f"complex128 {strategy} n={n}: "
                                         f"{err}")
            print(line)
            if res.state.dtype != np.complex128 or any(counts.values()):
                raise AssertionError(f"complex128 {strategy} n={n}: "
                                     f"{res.state.dtype}, launches {counts}")
            states[(n, strategy)] = res.state
            del first, res
    n = C128_WIDTHS[-1]
    err = float(np.max(np.abs(states[(n, "mxu")]
                              - states[(n, "megakernel")])))
    print(f"complex128 n={n}: mxu vs megakernel max|diff| {err:.3e}")
    if not err <= C128_TOL:
        raise AssertionError(f"complex128 n={n}: mxu vs megakernel {err}")
    clear_caches(torch)


def run_default_phase(torch, T, refs, highest24, add):
    """Phase 10: the "default" rung's four kernels, their drift, the rung
    through the engines, and complex128."""
    t0 = time.perf_counter()
    mat, split = check_default_mat(torch)
    chain = check_default_chain(torch)
    mm = check_default_mm(torch)
    check_high_drift(torch, "default")
    run_default_paths(torch, T, refs, highest24, add)
    run_complex128(torch, T, refs)
    print(f"default rung and complex128: phase 10 in "
          f"{time.perf_counter() - t0:.1f} s")
    return [(mat, "mat_default"), (split, "split_mat_default"),
            (chain, "kh0_default"), (mm, "mm_default")]


# ------------------------------------------- phase 11: the sharded engines
SHARD_REF = (23, 8)         # (n, shards): grover_like at "highest" vs f64
SHARD_HIGH = (24, 4)        # "auto" ("high") vs phase 4's "highest" state
SHARD_FULL = (31, 8)        # nl = 28: the JAX package's scale target
SHARD_MIRROR = (400, 31)    # grover_like(31, 400, 31), then its inverse
SHARD_PEAK = 34 << 30       # peak device memory of the n=31 runs: the
                            # state (16 GiB) and its spare pair (16 GiB)
SHARD_SAMPLES = 1000
SHARD_C128 = (20, 4)        # complex128 through the dense engine
SHARD_ITERATED = 4          # shards of the iterated Grover run (n=24)
SHARD_RELOAD = (4, 2)       # shard counts the n=24 checkpoint reloads onto


def shard_sim(T, shards, **kw):
    """The sharded strategy over ``shards`` shards on the first card."""
    return T.Simulator(T.SimulatorConfig(strategy="sharded",
                                         mesh_shape=(shards,), **kw),
                       device=["cuda:0"] * shards)


def shard_reset():
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP

    reset_counts()
    SP.gswap.launches = 0


def newest_shard_program():
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP

    return list(SP._RUN_CACHE.values())[-1]


def check_shard_counts(what, counts, modes, shards, runs, high):
    """Launch counts of ``runs`` runs of a segmented sharded program against
    its plan: block launches, relayouts once a shard and standalone
    relayout, gswaps once an entry and the gswap kernel once a shard and
    entry, no folded input (the sharded chains do not fold), and the mat
    step of the rung."""
    block = (counts["mat"] + counts["mat_high"] + counts["mat_default"]
             + counts["gather"])
    bad = []
    if block <= 0:
        bad.append("no block launch")
    if counts["relayout"] != runs * shards * modes.get(3, 0):
        bad.append(f"relayouts {counts['relayout']} for {modes.get(3, 0)} "
                   f"rows x {shards} shards x {runs}")
    if not (counts["gswap"] == runs * modes.get(4, 0) and modes.get(4, 0)):
        bad.append(f"gswaps {counts['gswap']} for {modes.get(4, 0)} rows "
                   f"x {runs}")
    if counts["gswap_halves"] != runs * shards * modes.get(4, 0):
        bad.append(f"gswap kernel launches {counts['gswap_halves']} for "
                   f"{modes.get(4, 0)} rows x {shards} shards x {runs}")
    if counts["folded"]:
        bad.append(f"folded launches {counts['folded']}")
    if high != (counts["mat_high"] > 0) or high == (counts["mat"] > 0):
        bad.append(f"mat {counts['mat']}, mat_high {counts['mat_high']} at "
                   f"high={high}")
    if bad:
        raise AssertionError(f"{what}: {bad}")


def short_counts(counts):
    keys = ("mat", "mat_high", "gather", "relayout", "gswap", "gswap_halves")
    return {k: counts[k] for k in keys}


SHARD_GSWAP = (8, 1 << 28)   # phase 11's shards of n = 31 on one card
GSWAP_REPS = 3


def check_gswap_halves(torch, devices, numel, reps=GSWAP_REPS):
    """parallel/sharded.py's gswap kernel (``gswap_halves``) against its
    plain version (``gswap_halves_plain``, torch view copies): one float32
    shard of ``numel`` amplitudes on each of ``devices``, exchanged at the
    segmented chain's local bit 7 with each shard-index bit.  Each kernel
    call launches once a shard, and its new shards are bit for bit those
    of the plain version: the kept half compared in place, the partner's
    half copied to the shard's device by a torch view copy and compared.
    Then each version is timed ``reps`` times, alternately, into the same
    pairs (every device synchronized around each, host clock).  Holds the
    shards, the new pairs and a half component a device: at 2^32
    amplitudes a card, 72 GiB.  Returns the median ms of each."""
    from gpu_quantum_simulator_tpu_torch.parallel import sharded as SD

    S, l = len(devices), 7
    hi, lo = numel >> (l + 1), 1 << l
    gen = torch.Generator(device="cpu").manual_seed(11)
    seeds = torch.randint(1 << 30, (S,), generator=gen).tolist()
    re, im = [], []
    for dev, sd in zip(devices, seeds):
        g = torch.Generator(device=dev).manual_seed(sd)
        re.append(torch.randn(numel, device=dev, generator=g))
        im.append(torch.randn(numel, device=dev, generator=g))
    pairs = [(torch.empty_like(r), torch.empty_like(i))
             for r, i in zip(re, im)]
    cards = sorted({torch.device(d).index for d in devices})

    def sync():
        for k in cards:
            torch.cuda.synchronize(k)

    def same(g):
        for s in range(S):
            my, p = (s >> g) & 1, s ^ (1 << g)
            for src, part, got in ((re[s], re[p], pairs[s][0]),
                                   (im[s], im[p], pairs[s][1])):
                v = got.view(hi, 2, lo)
                if not torch.equal(v[:, my], src.view(hi, 2, lo)[:, my]):
                    return False
                shipped = part.view(hi, 2, lo)[:, my].to(src.device)
                if not torch.equal(v[:, 1 - my], shipped):
                    return False
                del shipped
        return True

    bad, times = [], {"kernel": [], "plain": []}
    SD._on_cards(re)                 # peer access between the cards
    for g in range(S.bit_length() - 1):
        before = SD.gswap_halves.launches
        SD.gswap_halves(re, im, g, l, pairs)
        sync()
        if SD.gswap_halves.launches - before != S:
            bad.append(f"g={g}: {SD.gswap_halves.launches - before} "
                       f"launches for {S} shards")
        if not same(g):
            bad.append(f"g={g}: the kernel's shards differ")
        SD.gswap_halves_plain(re, im, g, l, pairs)
        sync()
        if not same(g):
            bad.append(f"g={g}: the plain version's shards differ")
    for _ in range(reps):
        for name, fn in (("kernel", SD.gswap_halves),
                         ("plain", SD.gswap_halves_plain)):
            sync()
            t0 = time.perf_counter()
            fn(re, im, 0, l, pairs)
            sync()
            times[name].append((time.perf_counter() - t0) * 1e3)
    del re, im, pairs
    torch.cuda.empty_cache()
    ms = {k: float(np.median(v)) for k, v in times.items()}
    print(f"gswap kernel over {S} shards of {numel} amplitudes on "
          f"{sorted(set(map(str, devices)))}: bit for bit the plain version "
          f"{not bad}; ms an exchange, kernel {times['kernel']}, torch view "
          f"copies {times['plain']}; median ratio "
          f"{ms['plain'] / ms['kernel']:.2f}")
    if bad:
        raise AssertionError(f"gswap kernel: {bad}")
    return ms


def check_sharded_reference(torch, T, refs, add):
    """(a) n=23 over eight shards at "highest" against the f64 reference."""
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP

    n, shards = SHARD_REF
    c = T.models.grover_like(n, 2445, 318)
    sim = shard_sim(T, shards, precision="highest")
    SP._RUN_CACHE.clear()
    shard_reset()
    res = sim.run_detailed(c)
    counts = launch_counts()
    add(counts)
    prog = newest_shard_program()
    err = float(np.max(np.abs(res.state - refs[n])))
    norm = float(np.linalg.norm(res.state))
    print(f"sharded n={n} over {shards} shards (nl={n - 3}) 'highest': "
          f"{res.num_fused_ops} items, {prog.plan.num_gswaps} gswaps, "
          f"{prog.plan.num_relayouts} relayouts; first run_detailed "
          f"{res.seconds:.3f} s (planning {prog.build_seconds:.3f} s); "
          f"max|amp - f64| {err:.3e}; norm {norm:.8f}; launches "
          f"{short_counts(counts)}")
    check_shard_counts(f"sharded n={n}", counts, prog.mode_rows, shards, 1,
                       False)
    if not (err <= AMP_TOL and abs(norm - 1.0) <= NORM_TOL
            and prog.plan.num_gswaps > 0):
        raise AssertionError(f"sharded n={n}: error {err}, norm {norm}")
    SP._RUN_CACHE.clear()


def check_sharded_high(torch, T, highest24, add):
    """(b) n=24 over four shards at "auto" ("high") against phase 4's
    "highest" state; returns the run's shard lists (for (f))."""
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP
    from gpu_quantum_simulator_tpu_torch.parallel.sharded import join_shards

    n, shards = SHARD_HIGH
    c = T.models.grover_like(n, 2445, 318)
    sim = shard_sim(T, shards)
    SP._RUN_CACHE.clear()
    shard_reset()
    t0 = time.perf_counter()
    re, im, nops = sim.run_device(c)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    prog = newest_shard_program()
    state = join_shards(re, im)
    err = float(np.max(np.abs(state - highest24)))
    scale = max(1.0, float(np.max(np.abs(highest24))) / HIGH_BAR_PEAK)
    print(f"sharded n={n} over {shards} shards 'auto' (high): {nops} items, "
          f"{prog.plan.num_gswaps} gswaps; first run_device {secs:.3f} s; "
          f"vs prefetch 'highest' max|diff| {err:.3e} (bar "
          f"{HIGH_TOL * scale:.3e}); launches {short_counts(counts)}")
    check_shard_counts(f"sharded n={n}", counts, prog.mode_rows, shards, 1,
                       True)
    if not 0.0 < err <= HIGH_TOL * scale:
        raise AssertionError(f"sharded n={n} 'high': {err}")
    SP._RUN_CACHE.clear()
    return re, im


def check_sharded_checkpoint(torch, T, re, im):
    """(f) the n=24 state saved shard by shard and reloaded onto four and
    two shards: bit for bit the saved state."""
    import tempfile

    from gpu_quantum_simulator_tpu_torch.parallel.mesh import make_mesh
    from gpu_quantum_simulator_tpu_torch.utils import checkpoint as CK

    n = SHARD_HIGH[0]
    flat_re, flat_im = torch.cat(re), torch.cat(im)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        CK.save_state_sharded(d, re, im, n, meta={"phase": 11})
        save = time.perf_counter() - t0
        same, loads = [], []
        for count in SHARD_RELOAD:
            mesh = make_mesh((count,), ("amp",), [re[0].device] * count)
            t0 = time.perf_counter()
            lre, lim, meta = CK.load_state_sharded(d, mesh=mesh)
            loads.append(time.perf_counter() - t0)
            same.append(len(lre) == count and meta["phase"] == 11
                        and torch.equal(torch.cat(lre), flat_re)
                        and torch.equal(torch.cat(lim), flat_im))
    print(f"sharded checkpoint n={n}: saved from {len(re)} shards in "
          f"{save:.3f} s, reloaded onto {SHARD_RELOAD} shards in "
          f"{[round(x, 3) for x in loads]} s, bit for bit {same}")
    if not all(same):
        raise AssertionError(f"sharded checkpoint: {same}")


def check_sharded_full(torch, T, add, smi):
    """(c) n=31 over eight shards (nl=28) on one card: the mirror circuit
    at "highest" (<0|psi> within MIRROR_TOL of 1, norm within NORM_TOL,
    read through sampling.py's sharded helpers), one timed run_device of
    grover_like(31, 2445, 318) at "auto" (planning and table seconds on
    the host apart from the chain's device seconds, CUDA events), the
    sampler on its state, ``Simulator.sample`` of the mirror (every shot
    |0>), and the peak device memory of all of it (<= SHARD_PEAK)."""
    from gpu_quantum_simulator_tpu_torch import sampling
    from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP

    n, shards = SHARD_FULL
    gib = float(1 << 30)
    clear_caches(torch)
    SP._RUN_CACHE.clear()
    torch.cuda.reset_peak_memory_stats()
    gates, seed = SHARD_MIRROR
    mirror = T.models.grover_like(n, gates, seed)
    mirror = mirror.compose(mirror.inverse())
    highest = shard_sim(T, shards, precision="highest")
    shard_reset()
    t0 = time.perf_counter()
    re, im, nops = highest.run_device(mirror)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    prog = newest_shard_program()
    amp0 = complex(sampling.amplitudes_device(re, im, [0])[0])
    norm = sampling.norm_device(re, im)
    del re, im
    print(f"sharded n={n} over {shards} shards (nl={n - 3}) mirror of "
          f"grover_like({n}, {gates}, {seed}) at 'highest': {nops} items, "
          f"{prog.plan.num_gswaps} gswaps, {prog.plan.num_relayouts} "
          f"relayouts; run_device {secs:.2f} s (planning "
          f"{prog.build_seconds:.2f} s); <0|psi> {amp0:.8f}; |psi|^2 "
          f"{norm:.8f}; launches {short_counts(counts)}")
    check_shard_counts(f"sharded n={n} mirror", counts, prog.mode_rows,
                       shards, 1, False)

    c = T.models.grover_like(n, 2445, 318)
    sim = shard_sim(T, shards)
    shard_reset()
    t0 = time.perf_counter()
    re, im, nops = sim.run_device(c)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    prog = newest_shard_program()
    start, end = prog._chain.events
    device_s = start.elapsed_time(end) / 1e3
    tnorm = sampling.norm_device(re, im)
    t0 = time.perf_counter()
    shots = sampling.sample_state_device(re, im, n, SHARD_SAMPLES, seed=1)
    sample_s = time.perf_counter() - t0
    del re, im
    print(f"sharded n={n} grover_like({n}, 2445, 318) at 'auto' (high): "
          f"{nops} items, {prog.plan.num_gswaps} gswaps, "
          f"{prog.plan.num_relayouts} relayouts, table chunks "
          f"{prog.chunk_sizes}; first run_device {wall:.2f} s = planning "
          f"{prog.build_seconds:.2f} s (host) + the chain, of which table "
          f"uploads and expansions {prog.table_seconds:.2f} s host time, "
          f"device {device_s:.2f} s (CUDA events, first to last entry); "
          f"norm {tnorm:.8f}; {SHARD_SAMPLES} samples from the sharded "
          f"state in {sample_s:.3f} s; launches {short_counts(counts)}; "
          f"{smi}")
    check_shard_counts(f"sharded n={n}", counts, prog.mode_rows, shards, 1,
                       True)
    t0 = time.perf_counter()
    zeros = highest.sample(mirror, SHARD_SAMPLES, seed=2)
    facade_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"sharded n={n}: Simulator.sample(mirror, {SHARD_SAMPLES}) "
          f"{facade_s:.2f} s (run and sampling), {int(np.sum(zeros == 0))} "
          f"shots |0>; peak device memory {peak / gib:.3f} GiB (bar "
          f"{SHARD_PEAK / gib:.0f})")
    SP._RUN_CACHE.clear()
    torch.cuda.empty_cache()
    bad = []
    if not abs(amp0 - 1.0) <= MIRROR_TOL:
        bad.append(f"mirror <0|psi> {amp0}")
    if not (abs(norm - 1.0) <= NORM_TOL and abs(tnorm - 1.0) <= NORM_TOL):
        bad.append(f"norms {norm}, {tnorm}")
    if not (shots.shape == (SHARD_SAMPLES,) and shots.min() >= 0
            and shots.max() < 1 << n and np.all(zeros == 0)):
        bad.append("samples")
    if peak > SHARD_PEAK:
        bad.append(f"peak {peak / gib:.3f} GiB")
    if bad:
        raise AssertionError(f"sharded n={n}: {bad}")


def check_sharded_complex128(torch, T, refs):
    """(d) complex128 through the dense engine: n=20 over four shards
    against the f64 reference (C128_TOL); torch ops, no kernel launch."""
    n, shards = SHARD_C128
    sim = shard_sim(T, shards, dtype="complex128")
    c = T.models.grover_like(n, 2445, 318)
    reset_counts()
    res = sim.run_detailed(c)
    counts = launch_counts()
    err = float(np.max(np.abs(res.state - refs[n])))
    print(f"sharded complex128 n={n} over {shards} shards (dense engine): "
          f"{res.num_fused_ops} items, run_detailed {res.seconds:.2f} s; "
          f"max|amp - f64| {err:.3e}; dtype {res.state.dtype}")
    if (sim._shard_segmented(n) or res.state.dtype != np.complex128
            or not err <= C128_TOL or any(counts.values())):
        raise AssertionError(f"sharded complex128 n={n}: {err}, {counts}")
    clear_caches(torch)


def check_sharded_iterated(torch, T, add):
    """(e) run_device_iterated of phase 7's Grover (n=24) over four shards
    at "highest", against phase 7's flat prefetch result at the natural
    71 repetitions and the exact f64 state, within phase 7's "highest"
    bar; launches = the prefix's + the body's once a repetition."""
    nd, marked = GROVER_DATA, GROVER_MARKED
    prefix, body, iters = T.models.grover_parts(nd, marked)
    n = body.num_qubits
    sim = shard_sim(T, SHARD_ITERATED, precision="highest")
    shard_reset()
    t0 = time.perf_counter()
    re, im, nops = sim.run_device_iterated(body, iters, prefix=prefix)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    _, programs = sim._iterated_programs(body, iters, prefix)
    gswaps = sum(p.mode_rows.get(4, 0) * reps for p, _, reps in programs)
    got = torch.complex(torch.cat(re).double(), torch.cat(im).double())
    del re, im
    exact = torch.zeros(1 << n, dtype=torch.float64)
    exact[:1 << nd] = torch.from_numpy(grover_exact(nd, marked, iters))
    exact = exact.cuda()
    scale = max(1.0, float(exact.abs().max()) / HIGH_BAR_PEAK)
    bar = AMP_TOL * scale * max(1.0, nops / BENCH_OPS)
    e_exact = float((got - exact).abs().max())
    flat = torch.complex(PHASE7_GROVER["re"].double(),
                         PHASE7_GROVER["im"].double()).cuda()
    e_flat = float((got - flat).abs().max())
    peak_at = int(torch.argmax(got.abs()))
    del got, exact, flat
    print(f"sharded iterated grover n={n} x{iters} over {SHARD_ITERATED} "
          f"shards 'highest': {nops} ops in {secs:.2f} s (first call); vs "
          f"phase 7's flat prefetch {e_flat:.3e}, vs exact f64 "
          f"{e_exact:.3e} (bar {bar:.3e}); peak at {peak_at}; gswaps "
          f"{counts['gswap']} (plan {gswaps}); launches "
          f"{short_counts(counts)}")
    if not (e_flat <= bar and e_exact <= bar and peak_at == marked
            and counts["gswap"] == gswaps and counts["gather"] > 0):
        raise AssertionError(f"sharded iterated: {e_flat}, {e_exact}, "
                             f"{peak_at}, {counts}")
    clear_caches(torch)


def run_sharded_phase(torch, T, refs, highest24, add, smi):
    """Phase 11: the sharded engines on one card (meshes repeating
    cuda:0)."""
    t0 = time.perf_counter()
    check_sharded_reference(torch, T, refs, add)
    re, im = check_sharded_high(torch, T, highest24, add)
    check_sharded_checkpoint(torch, T, re, im)
    del re, im
    check_sharded_complex128(torch, T, refs)
    check_sharded_iterated(torch, T, add)
    check_sharded_full(torch, T, add, smi)
    clear_caches(torch)
    shards, numel = SHARD_GSWAP
    check_gswap_halves(torch, ["cuda:0"] * shards, numel)
    print(f"sharded engines: phase 11 in {time.perf_counter() - t0:.1f} s")


def run_main_path(torch, T, refs, add):
    """Phase 4; returns prefetch's n=24 "highest" state."""
    highest24 = run_prefetch_path(torch, T, refs, add)
    run_mxu_path(torch, T, refs, highest24, add)
    run_pallas_path(torch, T, refs, add)
    run_vmem_path(torch, T, refs, add)
    run_small_widths(torch, T, refs, add)
    return highest24


def start_references(T, widths):
    """Start the f64 reference of each width (shared by every strategy),
    one thread a width, so that the host computes them while the card
    runs phase 3 (the native simulator runs without the interpreter
    lock).  Returns a callable that waits for them: ``{n: state}``."""
    from concurrent.futures import ThreadPoolExecutor

    from gpu_quantum_simulator_tpu_torch.ref.native import simulate_native

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=len(widths))
    futures = {n: pool.submit(simulate_native,
                              T.models.grover_like(n, 2445, 318))
               for n in sorted(widths)}

    def wait():
        try:
            refs = {n: f.result() for n, f in futures.items()}
        finally:
            pool.shutdown()
        print(f"f64 references n={sorted(refs)} ready "
              f"{time.perf_counter() - t0:.1f} s after their start (beside "
              f"phase 3)")
        return refs

    return wait


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
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "wgmma" in line):
                print("  ptxas:", line.strip())
    check_high_sass()
    native_fuse.get_lib()
    native.get_lib()

    totals: dict = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    rng = np.random.default_rng(2445)
    pending_refs = start_references(T, set(REF_WIDTHS) | set(VMEM_WIDTHS)
                                    | {C128_WIDTHS[0]})
    # phase 3: each kernel against its plain version
    block, mat = check_block_kernel(torch, rng)
    relayout = check_relayout_kernel(torch, rng)
    folded = check_folded_block(torch, rng)
    high = check_high_mat(torch, rng)
    chain, chain_high, block128 = check_wide_chain(torch, rng)
    mm_high = check_mm_high(torch)
    vmem_chunk, vmem_op = check_vmem_kernel(torch, T)
    check_high_drift(torch)
    check_chain_drift(torch)
    mxu_high_drift(torch)
    torch.cuda.empty_cache()

    # phase 4: the main paths, counting launches; phase 5: the in-place
    # engine, its kernels first
    refs = pending_refs()
    highest24 = run_main_path(torch, T, refs, add)
    inplace = run_inplace_phase(torch, T, refs, add, rng)
    # phase 6: the public op (kernel 10) and the copy probes (kernel 11),
    # which no engine path launches: the main paths counted none
    stray = {k: totals[k] for k in ("butterfly", "copy_grid", "copy_stream",
                                    "copy_direct") if totals.get(k)}
    if stray:
        raise AssertionError(f"kernel 10 or 11 ran on an engine path: {stray}")
    butterfly = check_butterfly(torch, rng, add)
    copies = check_copy_probes(torch, add)
    # phase 7: the facade's program entry points
    run_entry_points(torch, T, add, smi.splitlines()[0])
    # phase 8: the CLI and the per-gate strategies
    run_cli_phase(torch, T, refs, add)
    # phase 9: the workloads on the state
    run_workloads(torch, T, add)
    # phase 10: the "default" rung and complex128
    defaults = run_default_phase(torch, T, refs, highest24, add)
    # phase 11: the sharded engines, meshes repeating the card
    run_sharded_phase(torch, T, refs, highest24, add, smi.splitlines()[0])
    kinds = ((block, "gather"), (mat, "mat"), (relayout, "relayout"),
             (folded, "folded"), (high, "mat_high"), (chain, "kh0"),
             (chain_high, "kh0_high"), (block128, "block128"),
             (mm_high, "mm_high"),
             (vmem_chunk, "vmem"), (vmem_op, "vmem"), *inplace,
             (butterfly, "butterfly"), *copies, *defaults)
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
