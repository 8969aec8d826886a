"""Block kernel wrapper: one prefetch block (a step list) on the state.

Replaces ``gpu_quantum_simulator_tpu/engine/prefetch.py`` ``get_block_kernel``
(its step interpreter ``_steps_loop``) and ``get_stream_block_kernel``, its
streamed twin.  A block is one row of the planner's ``scal`` table,
``[nsteps, mode, pro_tmask, pro_shift, kinds..., midx..., sigma...]``:

* mode 0: plain; mode 1: steered — the block's INPUT is read with the
  pending cross-tile swap folded in (window bit 7 <-> tile-index bit
  ``pro_shift``, the JAX ``map_half``); mode 5: folded relayout — the
  block's INPUT is read through the relayout ``sigma`` (the stream
  kernel's ``in_folded``; see kernels/relayout.py).  Other modes are not
  blocks.
* step kinds (``logt`` = log2 of the tile rows the plan assumed):
  0 mat (table slot midx), 1..logt tswap k, logt+1 perm (lane v = midx),
  logt+2 mono (slot midx).
* precision rung of the mat step: "highest" (IEEE fp32 products),
  "high" (the 3-pass bf16 product of the JAX package's ``_make_dot``) or
  "default" (its one bf16 pass: x and the table rounded to bf16, the
  products summed in fp32, the hi.hi term of "high").  Perm, tswap and
  mono steps are exact gathers at every rung.

``run_block`` launches the CUDA kernels of ``csrc/prefetch_block.cu`` and
``csrc/mat_high.cu`` for a CUDA state (one launch per step, ping-ponging
between the state and a scratch pair) and runs ``run_block_plain`` — the
same function in plain torch — for a CPU state.  Any other device raises.
``run_block.launches`` counts kernel launches by kind: ``mat`` (fp32 mat
step), ``mat_high`` ("high" mat step), ``mat_default`` ("default" mat
step: the "high" kernel's "default" arm, csrc/mat_high.cu, which reads
the hi words of ``split_tables``),
``gather`` (every other step and a prologue-only block) and ``folded``
(the first launch of a mode-5 block, whichever step it runs); each launch
is counted under one kind.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import contextlib

import numpy as np
import torch

from .. import telemetry
from . import build
from .relayout import run_relayout_plain

LANE_QUBITS = 7
LOCAL_QUBITS = 8
DVIEW = 256
RUNGS = ("highest", "high", "default")
SPLIT_RUNGS = ("high", "default")   # rungs whose mat step reads split_tables
HIGH_COL_BLOCKS = 4        # the "high" kernel's column blocks of 64
HIGH_SLOT_WORDS = DVIEW * DVIEW * 2   # int32 words: four bf16 tables a slot
LAUNCH_KINDS = ("mat", "mat_high", "mat_default", "gather", "folded")

Pair = Tuple[torch.Tensor, torch.Tensor]


def _check_mode(mode: int, sigma) -> None:
    if mode not in (0, 1, 5):
        raise ValueError(
            f"block mode {mode}: the port's blocks are plain (0), steered "
            "(1) and folded relayout (5); the in-place xswap (2) is an "
            "entry of in-place plans, the relayout (3) a kernel of its own, "
            "and the mesh gswap (4) an entry of the sharded chain "
            "(parallel/sharded_prefetch.py)")
    if (mode == 5) != (sigma is not None):
        raise ValueError(f"block mode {mode}: a sigma is given exactly for "
                         "a folded relayout (mode 5)")


def _check_rung(precision: str) -> None:
    if precision not in RUNGS:
        raise ValueError(f"precision {precision!r}: the rungs are {RUNGS}")


@contextlib.contextmanager
def ieee_fp32():
    """Run float32 matmuls in IEEE fp32 (no TF32) whatever the process-wide
    setting is, and restore that setting afterwards."""
    saved = torch.get_float32_matmul_precision()
    if saved != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved != "highest":
            torch.set_float32_matmul_precision(saved)


def swap_bits(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``x`` (any shape, 2^m elements) with flat index bits a and b exchanged."""
    if a == b:
        return x
    if a > b:
        a, b = b, a
    m = x.numel().bit_length() - 1
    t = x.reshape(1 << (m - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)
    return t.transpose(1, 3).reshape(x.shape)


def _steer_bit(scal, logt: int) -> int:
    """Flat bit the steered prologue exchanges with bit 7 (-1: plain)."""
    return LOCAL_QUBITS + logt + int(scal[3]) if int(scal[1]) == 1 else -1


def bf16_split(x: torch.Tensor) -> Pair:
    """(hi, lo) of a float32 tensor: hi = x rounded to bfloat16, lo = the
    bfloat16 of the residual x - hi, both as float32 (bf16-exact) values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _dot_high(x: Pair, m: Pair) -> torch.Tensor:
    """xh @ mh + xl @ mh + xh @ ml, float32 matmuls of bf16-exact values."""
    return x[0] @ m[0] + x[1] @ m[0] + x[0] @ m[1]


def mat_high_plain(re: torch.Tensor, im: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> Pair:
    """The "high" rung's complex mat step in plain torch (schoolbook, as
    the kernel): (re + i im) @ (a + i b) with every real product the
    3-pass bf16 split.  Exact-product sums, so on a card it needs TF32
    off, as every plain matmul here."""
    xr, xi = bf16_split(re), bf16_split(im)
    ma, mb = bf16_split(a), bf16_split(b)
    return (_dot_high(xr, ma) - _dot_high(xi, mb),
            _dot_high(xr, mb) + _dot_high(xi, ma))


def mat_default_plain(re: torch.Tensor, im: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> Pair:
    """The "default" rung's complex mat step in plain torch (schoolbook, as
    the kernel): every real product ``xh @ mh``, float32 matmuls of
    bf16-exact values (h = the bf16 rounding) in IEEE fp32."""
    xr, xi = bf16_split(re)[0], bf16_split(im)[0]
    ma, mb = bf16_split(a)[0], bf16_split(b)[0]
    with ieee_fp32():
        return xr @ ma - xi @ mb, xr @ mb + xi @ ma


def kernel_order(t: torch.Tensor) -> torch.Tensor:
    """(..., 256, 256) tables [k][n] -> (..., 4, 16, 1024): per 64-column
    block and k-chunk of 16, 16-byte core matrices [kc 2][n 64][8],
    position 8 c + 2 a + b of the chunk holding k 4 a + 2 c + b (the order
    of each part of ``split_tables``)."""
    lead = t.shape[:-2]
    # k = 16 q + 4 a + 2 c + b, n = 64 cb + nn -> (cb, q, c, nn, a, b)
    t = t.reshape(*lead, DVIEW // 16, 4, 2, 2, HIGH_COL_BLOCKS,
                  DVIEW // HIGH_COL_BLOCKS)
    t = t.permute(*range(len(lead)),
                  *(t.dim() + d for d in (-2, -6, -4, -1, -5, -3)))
    return t.reshape(*lead, HIGH_COL_BLOCKS, DVIEW // 16, -1)


def split_tables(a_tab: torch.Tensor, b_tab: torch.Tensor) -> torch.Tensor:
    """(..., 256, 256) float32 tables [k][n] (A = M_re^T, B = M_im^T) ->
    (..., HIGH_SLOT_WORDS) int32: the bfloat16 operands of the "high" mat
    kernel (csrc/wgmma_high.cuh) in the shared-memory image it bulk-copies,
    two to a 32-bit word.  Per 64-column block and k-chunk of 16, four
    parts A_hi, A_lo, B_hi, B_lo (hi = the table rounded to bf16, lo = the
    bf16 of the residual: the JAX package's mh, ml), each 16-byte core
    matrices [kc 2][n 64][8], wgmma position 8 c + 2 a + b of the chunk
    holding k 4 a + 2 c + b.  Done once per circuit (DeviceChain), or per
    part in place, since the tables are fixed."""
    lead = a_tab.shape[:-2]
    parts = []
    for t in (a_tab, b_tab):
        t = kernel_order(t)
        hi = t.to(torch.bfloat16)
        parts += [hi, (t - hi.float()).to(torch.bfloat16)]
    return torch.stack(parts, -2).reshape(*lead, -1).view(torch.int32)


def check_high_tables(high_tables: torch.Tensor, cap: int,
                      what: str) -> None:
    """Raise unless ``high_tables`` is ``split_tables`` of ``cap`` slots."""
    if high_tables.dtype != torch.int32 \
            or tuple(high_tables.shape) != (cap, HIGH_SLOT_WORDS) \
            or not high_tables.is_contiguous():
        raise ValueError(f"{what}: high_tables must be contiguous int32 "
                         f"({cap}, {HIGH_SLOT_WORDS}) (split_tables), got "
                         f"{high_tables.dtype} {tuple(high_tables.shape)}")


def run_block_plain(scal: Sequence[int], re: torch.Tensor, im: torch.Tensor,
                    a_tab: torch.Tensor, b_tab: torch.Tensor,
                    mono_src: torch.Tensor, logt: int, cap_steps: int,
                    sigma: Optional[Sequence[int]] = None, tr: int = 1,
                    precision: str = "highest") -> Pair:
    """The block in plain torch on (R2, 256) float32 tensors, any device.

    A folded block (mode 5) is the relayout ``sigma`` over ``tr``-row
    blocks (``run_relayout_plain``) followed by the steps.  mat is
    ``x @ A`` complex with A = M_re^T + i M_im^T from the slot's tables:
    float32 products at "highest" (on a card with TF32 off), the 3-pass
    bf16 split at "high" (``mat_high_plain``), one bf16 pass at "default"
    (``mat_default_plain``); every other step is the exact index map the
    kernel applies.
    """
    mode = int(scal[1])
    _check_mode(mode, sigma)
    _check_rung(precision)
    if mode == 5:
        re, im = run_relayout_plain(sigma, re, im, tr)
    steer = _steer_bit(scal, logt)
    if steer >= 0:
        re = swap_bits(re, LANE_QUBITS, steer)
        im = swap_bits(im, LANE_QUBITS, steer)
    for j in range(int(scal[0])):
        kind = int(scal[4 + j])
        idx = int(scal[4 + cap_steps + j])
        if kind == 0:
            a, b = a_tab[idx], b_tab[idx]
            if precision == "high":
                re, im = mat_high_plain(re, im, a, b)
            elif precision == "default":
                re, im = mat_default_plain(re, im, a, b)
            else:
                re, im = re @ a - im @ b, re @ b + im @ a
        elif kind <= logt:
            re = swap_bits(re, LANE_QUBITS, LANE_QUBITS + kind)
            im = swap_bits(im, LANE_QUBITS, LANE_QUBITS + kind)
        elif kind == logt + 1:
            re = swap_bits(re, idx, LANE_QUBITS)
            im = swap_bits(im, idx, LANE_QUBITS)
        elif kind == logt + 2:
            src = mono_src[idx].long()
            gr, gi = re[:, src], im[:, src]
            c, s = b_tab[idx, 0], b_tab[idx, 1]
            re, im = gr * c - gi * s, gr * s + gi * c
        else:
            raise ValueError(f"unknown step kind {kind} (logt = {logt})")
    return re, im


def _check_cuda(tensors, dtypes) -> None:
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"block kernel: tensors must share one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"block kernel: expected contiguous {dt}, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")


@telemetry.counted
def run_block(scal: Sequence[int], re: torch.Tensor, im: torch.Tensor,
              a_tab: torch.Tensor, b_tab: torch.Tensor,
              mono_src: torch.Tensor, logt: int, cap_steps: int,
              scratch: Pair = None, sigma: Optional[Sequence[int]] = None,
              tr: int = 1, precision: str = "highest",
              high_tables: Optional[torch.Tensor] = None) -> Pair:
    """Apply one block to the (R2, 256) float32 state pair (re, im).

    On CUDA the result lands in either the input pair or ``scratch`` (a
    pair of the same shape, allocated here when None); the other pair is
    free for the caller's next entry.  ``a_tab``/``b_tab`` are the entry's
    (cap, 256, 256) tables, ``mono_src`` its (cap, 256) int32 gathers,
    ``sigma``/``tr`` a mode-5 block's folded relayout, and
    ``high_tables`` the entry's ``split_tables`` for the "high" and
    "default" rungs (computed here when None; checked on every device when
    given).
    """
    if high_tables is not None:
        check_high_tables(high_tables, a_tab.shape[0], "block kernel")
    if re.device.type == "cpu":
        return run_block_plain(scal, re, im, a_tab, b_tab, mono_src, logt,
                               cap_steps, sigma, tr, precision)
    if not re.is_cuda:
        raise ValueError(f"block kernel: unsupported device {re.device}")
    mode = int(scal[1])
    _check_mode(mode, sigma)
    _check_rung(precision)
    rows = re.shape[0]
    if re.shape != (rows, DVIEW) or im.shape != re.shape:
        raise ValueError(f"block kernel: state must be (R2, {DVIEW}), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if a_tab.shape[1:] != (DVIEW, DVIEW) or b_tab.shape != a_tab.shape \
            or mono_src.shape != a_tab.shape[:2]:
        raise ValueError("block kernel: tables must be (cap, 256, 256) and "
                         "mono_src (cap, 256)")
    nsteps = int(scal[0])
    fold = None
    if mode == 5:
        if nsteps == 0 or rows % tr or len(sigma) != (rows // tr - 1).bit_length():
            raise ValueError(f"block kernel: a folded block needs steps and "
                             f"one sigma entry per row-block bit (rows "
                             f"{rows}, tr {tr}, sigma {list(sigma)})")
        fold = np.ascontiguousarray(np.asarray(sigma, dtype=np.int32))
    high = precision in SPLIT_RUNGS and any(
        int(scal[4 + j]) == 0 for j in range(nsteps))
    if high and high_tables is None:
        high_tables = split_tables(a_tab, b_tab)
    if scratch is None:
        scratch = (torch.empty_like(re), torch.empty_like(im))
    f32 = torch.float32
    tensors = [re, im, *scratch, a_tab, b_tab, mono_src]
    dtypes = [f32] * 6 + [torch.int32]
    if high:
        tensors.append(high_tables)
        dtypes.append(torch.int32)
    _check_cuda(tensors, dtypes)
    steer = _steer_bit(scal, logt)
    if nsteps == 0 and steer < 0:
        return re, im                      # padding row: identity
    lib = build.load()
    stream = torch.cuda.current_stream(re.device).cuda_stream
    slot = DVIEW * DVIEW * 4               # bytes per table slot
    a0, b0, m0 = a_tab.data_ptr(), b_tab.data_ptr(), mono_src.data_ptr()
    w0 = high_tables.data_ptr() if high else None
    total = rows * DVIEW
    src, dst = (re, im), scratch
    counts = run_block.launches

    def fold_args():
        # the folded relayout rides the block's first launch only
        if fold is None:
            return None, 0, 1
        return fold.ctypes.data, len(fold), tr

    def gather(swap_a, swap_b, col_src=None, cs=None):
        return lib.qsim_gather_step(
            src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
            dst[1].data_ptr(), total, swap_a, swap_b, steer, col_src, cs,
            *fold_args(), stream)

    if nsteps == 0:                        # prologue-only block
        build.check(lib, gather(-1, -1), "block kernel (prologue)")
        counts["gather"] += 1
        return dst
    for j in range(nsteps):
        kind = int(scal[4 + j])
        idx = int(scal[4 + cap_steps + j])
        if kind == 0 and high:
            what = "mat_" + precision
            rc = lib.qsim_mat_step_high(
                src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                dst[1].data_ptr(), w0 + idx * HIGH_SLOT_WORDS * 4, rows,
                steer, *fold_args(), int(precision == "high"), stream)
        elif kind == 0:
            what = "mat"
            rc = lib.qsim_mat_step(
                src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                dst[1].data_ptr(), a0 + idx * slot, b0 + idx * slot, rows,
                steer, *fold_args(), stream)
        elif kind <= logt:
            what = "gather"
            rc = gather(LANE_QUBITS, LANE_QUBITS + kind)
        elif kind == logt + 1:
            what = "gather"
            rc = gather(idx, LANE_QUBITS)
        elif kind == logt + 2:
            what = "gather"
            rc = gather(-1, -1, m0 + idx * DVIEW * 4, b0 + idx * slot)
        else:
            raise ValueError(f"unknown step kind {kind} (logt = {logt})")
        build.check(lib, rc, f"block kernel (step kind {kind})")
        counts["folded" if fold is not None else what] += 1
        steer = -1
        fold = None
        src, dst = dst, src
    return src


def reset_launches() -> None:
    """Set every launch count of ``run_block`` to 0."""
    run_block.launches = dict.fromkeys(LAUNCH_KINDS, 0)


reset_launches()
