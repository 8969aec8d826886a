"""Wide-matmul engine (the ``mxu`` strategy): every fused block is one
complex matrix product on the lane-layout state.

A port of the JAX package's ``engine/wide.py``.  The state is the (R, 128)
float32 pair (float64 for complex128), R = 2^(n-7), with the low 7 qubits
on the columns.  A block
over qubits L ∪ H (L ⊆ [0, 7), H = kh high qubits, kh <= 2 by the fuser's
``max_high``) is expanded on the host over the lane qubits plus H into a
D x D matrix, D = 2^(7+kh) <= 512, and applied as

    row shuffle  ->  (R', D) @ (D, D)^T  ->  inverse row shuffle.

The host half — ``_op_spec``, ``row_shuffles`` (kept in kernels/wide.py,
beside the kernel that reads the same map), the step list of
``WideProgram`` per 128-op segment, the power-of-two padding of kh = 0 runs
and ``num_kh0_runs`` — is the JAX package's, step for step.  The device
half differs:

* a run of up to ``KH0_BATCH`` consecutive kh = 0 blocks (``("kh0", run,
  P)``) is one launch of the chain kernel (kernels/wide.py ``kh0_chain``,
  csrc/wide_chain.cu; TPU kernel 7), in place, Karatsuba products at every
  rung (IEEE fp32 at "highest", the mm step's 3-pass bf16 products on the
  row tile held on chip at "high", their hi.hi term alone, on a body of
  its own, at "default"), without the identity pads (P records the padded
  length);
* every other block (``("mm", D, idx, row_bits)``) is the JAX package's
  Karatsuba product.  At "highest" it runs between row shuffles
  (``permute`` copies), the three real products ``torch.matmul`` in IEEE
  fp32 (whatever the process-wide TF32 setting), as the JAX package
  leaves them to XLA; the shuffled temporaries are dropped as soon as the
  step no longer needs them (the JAX package donates its state pair
  instead).  At "high" the step is one launch of the hand-written kernel
  csrc/mm_high.cu (kernels/wide.py ``mm_step_high``; its plain version on
  the CPU), which reads and writes the state through the row map (no
  shuffle copy) and keeps the hi.hi sums out of the tensor core's
  truncating adds; it writes into a second pair, one per run, which then
  swaps with the state (a kh = 0 chain runs in place on whichever pair is
  current).  At "default" it is the same kernel's one-pass instantiation
  (``mm_step_default``).

complex128 (``dtype=torch.float64``) is the JAX package's parity arm:
there kh0_pallas is off below float32, so every block, kh = 0 included, is
an XLA dot between row shuffles, in float64 whatever the rung.  Here
likewise: no kh0 run is planned, every block is ``_mm_step``'s float64
``torch.matmul`` Karatsuba between row shuffles, the tables are float64
from the host on, and the rung is not read (the program runs as
"highest").

Tables go to the device once per program (``build_wide_program`` caches
programs by their ops); at "high" and "default" the Karatsuba combinations
of every mm step and kh = 0 run are formed in float64 and split to bf16
once as well, into the image the rung's kernels read (``rung_mm_tables``):
``split_mm_tables`` (hi and lo parts) at "high", ``split_mm_tables_hi``
(the hi parts alone) at "default".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import telemetry
from ..ir.oplist import Op, expand_unitary, op_matrix, ops_digest
from ..kernels.block import RUNGS, SPLIT_RUNGS
from ..kernels.wide import (MM_STEPS, ieee_fp32, kh0_chain, row_shuffles,
                            rung_mm_tables)
from ..ops.apply import resolve_device, upload

LANE_QUBITS = 7
LANES = 1 << LANE_QUBITS

# The JAX package's kernel 7 tiles 512 state rows; the port's chain kernel
# tiles 64 (csrc/wide_chain.cu).  No step list depends on either.
KH0_TILE_ROWS = 512
KH0_BATCH = 8           # max consecutive kh0 blocks fused into one pass

# Ops per segment, as in the JAX package (which compiles each segment
# separately); the step lists are cut at the same places.
SEGMENT_OPS = 128


def _op_spec(op: Op, n: int):
    """(kh, row_bits, D, big_re, big_im) for one fused block."""
    u, qs = op_matrix(op)
    high = sorted(q for q in qs if q >= LANE_QUBITS)
    kh = len(high)
    superset = tuple(range(min(LANE_QUBITS, n))) + tuple(high)
    big = expand_unitary(np.asarray(u, dtype=np.complex128), qs, superset)
    row_bits = tuple(q - LANE_QUBITS for q in high)  # ascending
    D = (1 << kh) * LANES
    return kh, row_bits, D, big.real, big.imag


def _karatsuba(bre: np.ndarray, bim: np.ndarray) -> np.ndarray:
    """(3, D, D) float64: a block's Karatsuba tables m1 = M_re^T, m2 =
    (M_im - M_re)^T, m3 = (M_re + M_im)^T, as the JAX package forms
    them."""
    return np.stack([bre.T, (bim - bre).T, (bre + bim).T])


def _mm_step(state: list, spare: list, m, row_bits, R: int,
             precision: str) -> None:
    """One kh >= 1 block (or kh = 0 without the chain kernel) on
    ``state = [re, im]`` (R, 128), replaced in place by the result.

    ``m``: at "highest" the (3, D, D) Karatsuba combinations m1 = M_re^T,
    m2 = (M_im - M_re)^T, m3 = (M_re + M_im)^T in the state's dtype
    (float32 or float64), and out_re = t1 - t3, out_im = t1 + t2 with
    t1 = (x_re + x_im) @ m1, t2 = x_re @ m2, t3 = x_im @ m3 (IEEE fp32, or
    float64) between ``row_shuffles`` copies; at "high" and "default"
    their ``rung_mm_tables`` image, the same product as one
    ``mm_step_high`` / ``mm_step_default`` (the kernel csrc/mm_high.cu on
    a card, which reads and writes the state through the row map, its
    plain version on the CPU) into ``spare``, a pair of the state's shape
    (empty before the first such step), after which the two pairs swap."""
    if precision in SPLIT_RUNGS:
        out = MM_STEPS[precision](state[0], state[1], m, row_bits,
                                  out=tuple(spare) if spare else None)
        spare[:] = state
        state[:] = out
        return
    fwd, bwd = row_shuffles(row_bits, R)
    xr, xi = fwd(state[0]), fwd(state[1])
    state.clear()
    t1 = (xr + xi) @ m[0]
    t2 = xr @ m[1]
    del xr
    t3 = xi @ m[2]
    del xi
    t2 += t1
    t1 -= t3
    del t3
    state.append(bwd(t1))
    del t1
    state.append(bwd(t2))


def _kh(op: Op) -> int:
    return sum(1 for q in op.qubits if q >= LANE_QUBITS)


def plan_segments(ops: Sequence[Op], num_qubits: int, chain: bool = True):
    """The JAX package's step lists, without tables.

    Per 128-op segment: ``(steps, buckets, runs)`` — ``steps`` the step
    tuples ``("kh0", run, P)`` / ``("mm", D, idx, row_bits)``, ``buckets``
    D -> the indices into ``ops`` of that D's mm steps in order, ``runs``
    each kh0 run's op indices (P is its length padded to a power of two).
    kh = 0 blocks chain when ``chain`` (float32; False for float64) and
    R >= 8, the JAX package's rule (its kh0_pallas), kept on every device
    so the step lists agree; otherwise every block is an mm step.
    """
    chain = chain and (1 << (num_qubits - LANE_QUBITS)) >= 8
    segments = []
    for s0 in range(0, max(len(ops), 1), SEGMENT_OPS):
        buckets: Dict[int, list] = {}
        steps: list = []
        runs: List[list] = []
        pending: list = []

        def flush_run():
            if pending:
                P = 1 << (len(pending) - 1).bit_length()
                steps.append(("kh0", len(runs), P))
                runs.append(list(pending))
                pending.clear()

        for i in range(s0, min(s0 + SEGMENT_OPS, len(ops))):
            kh = _kh(ops[i])
            if chain and kh == 0:
                # consecutive kh0 blocks chain inside ONE state pass
                pending.append(i)
                if len(pending) == KH0_BATCH:
                    flush_run()
                continue
            flush_run()
            row_bits = tuple(sorted(q - LANE_QUBITS for q in ops[i].qubits
                                    if q >= LANE_QUBITS))
            bucket = buckets.setdefault((1 << kh) * LANES, [])
            steps.append(("mm", (1 << kh) * LANES, len(bucket), row_bits))
            bucket.append(i)
        flush_run()
        segments.append((steps, buckets, runs))
    return segments


@dataclass
class _Segment:
    steps: list                     # the JAX package's step tuples
    mm: dict                        # D -> (count, 3, D, D) float32 (or
                                    # float64), or at "high" (count, 6 D^2)
                                    # bfloat16 (split_mm_tables), at
                                    # "default" (count, 3 D^2)
                                    # (split_mm_tables_hi)
    runs: List[torch.Tensor]        # (L, 2, 128, 128) float32 [M_re, M_im]
    runs_w16: list                  # per run at "high" (L, 6 * 128^2)
                                    # bfloat16 (split_mm_tables), at
                                    # "default" (L, 3 * 128^2)
                                    # (split_mm_tables_hi), else None


class WideProgram:
    """A wide-matmul circuit program with its device-resident tables.

    Calling it maps a flat (2^n,) state pair through every step and returns
    the new pair; the input pair is handed over (the chain kernel writes
    into it).  ``dtype``: the state's float dtype, float32 or float64 (the
    complex128 arm: no chain, every block a float64 matmul step, the rung
    not read)."""

    def __init__(self, ops: Sequence[Op], num_qubits: int,
                 precision: str = "highest", device="cuda",
                 dtype: torch.dtype = torch.float32):
        n = num_qubits
        if n <= LANE_QUBITS:
            raise ValueError(f"the wide engine needs n > {LANE_QUBITS}")
        if precision not in RUNGS:
            raise ValueError(f"precision {precision!r}: the wide engine "
                             f"runs the rungs {RUNGS}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype}: float32 or float64")
        f32 = dtype == torch.float32
        self.num_qubits = n
        self.dtype = dtype
        self.precision = precision if f32 else "highest"
        self.device = resolve_device(device)
        self._R = 1 << (n - LANE_QUBITS)
        high = self.precision in SPLIT_RUNGS
        np_dtype = np.float32 if f32 else np.float64

        def dev(a, rung=False):
            """The table ``a`` on the device; with ``rung`` in the image
            the rung's kernels read."""
            a = np.asarray(a, dtype=np_dtype)
            with telemetry.span("qsim/tables"):
                t = upload(a, self.device)
                return rung_mm_tables(t, self.precision) if rung else t

        self.segments: List[_Segment] = []
        self.num_kh0_runs = 0
        for steps, buckets, runs in plan_segments(ops, n, chain=f32):
            mm = {}
            for D, idxs in buckets.items():
                mm[D] = dev(np.stack([_karatsuba(*_op_spec(ops[i], n)[3:])
                                      for i in idxs]), rung=high)
            specs = [[_op_spec(ops[i], n)[3:] for i in run] for run in runs]
            run_tabs = [dev(np.stack([np.stack(m) for m in ms]))
                        for ms in specs]
            w16 = [dev(np.stack([_karatsuba(*m) for m in ms]), rung=True)
                   if high else None for ms in specs]
            self.segments.append(_Segment(steps, mm, run_tabs, w16))
            self.num_kh0_runs += len(runs)

    def __call__(self, re: torch.Tensor, im: torch.Tensor):
        R = self._R
        state = [re.reshape(R, LANES), im.reshape(R, LANES)]
        spare: list = []        # the "high" mm steps' other pair
        del re, im
        with ieee_fp32():
            for seg in self.segments:
                for st in seg.steps:
                    if st[0] == "kh0":
                        r = st[1]
                        kh0_chain(*state, seg.runs[r], self.precision,
                                  out=tuple(state), w16=seg.runs_w16[r])
                    else:
                        _, D, idx, row_bits = st
                        _mm_step(state, spare, seg.mm[D][idx], row_bits,
                                 R, self.precision)
        return state[0].reshape(-1), state[1].reshape(-1)


_CACHE: dict = {}
_CACHE_LIMIT = 16


def build_wide_program(ops: Sequence[Op], num_qubits: int,
                       precision: str = "highest", device="cuda",
                       dtype: torch.dtype = torch.float32) -> WideProgram:
    device = resolve_device(device)
    key = ops_digest(ops, f"{num_qubits}|{precision}|{device}|{dtype}")
    prog = telemetry.lookup(_CACHE, key)
    if prog is None:
        prog = WideProgram(ops, num_qubits, precision=precision,
                           device=device, dtype=dtype)
        if len(_CACHE) >= _CACHE_LIMIT:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = prog
    return prog
