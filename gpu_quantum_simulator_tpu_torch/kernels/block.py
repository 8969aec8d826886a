"""Block kernel wrapper: one prefetch block (a step list) on the state.

Replaces ``gpu_quantum_simulator_tpu/engine/prefetch.py`` ``get_block_kernel``
(its step interpreter ``_steps_loop``).  A block is one row of the planner's
``scal`` table, ``[nsteps, mode, pro_tmask, pro_shift, kinds..., midx...]``:

* mode 0: plain; mode 1: steered — the block's INPUT is read with the
  pending cross-tile swap folded in (window bit 7 <-> tile-index bit
  ``pro_shift``, the JAX ``map_half``).  Other modes are not blocks.
* step kinds (``logt`` = log2 of the tile rows the plan assumed):
  0 mat (table slot midx), 1..logt tswap k, logt+1 perm (lane v = midx),
  logt+2 mono (slot midx).

``run_block`` launches the CUDA kernels of ``csrc/prefetch_block.cu`` for a
CUDA state (one launch per step, ping-ponging between the state and a
scratch pair) and runs ``run_block_plain`` — the same function in plain
torch — for a CPU state.  Any other device raises.  ``run_block.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import build

LANE_QUBITS = 7
LOCAL_QUBITS = 8
DVIEW = 256

Pair = Tuple[torch.Tensor, torch.Tensor]


def _check_mode(mode: int) -> None:
    if mode not in (0, 1):
        raise NotImplementedError(
            f"block mode {mode}: only plain (0) and steered (1) blocks are in "
            "the port's slice (modes 2/4/5 are ROADMAP queue A items)")


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


def run_block_plain(scal: Sequence[int], re: torch.Tensor, im: torch.Tensor,
                    a_tab: torch.Tensor, b_tab: torch.Tensor,
                    mono_src: torch.Tensor, logt: int,
                    cap_steps: int) -> Pair:
    """The block in plain torch on (R2, 256) float32 tensors, any device.

    mat is ``x @ A`` complex with A = M_re^T + i M_im^T from the slot's
    tables (float32 products; on a card with TF32 off); every other step is
    the exact index map the kernel applies.
    """
    mode = int(scal[1])
    _check_mode(mode)
    steer = _steer_bit(scal, logt)
    if steer >= 0:
        re = swap_bits(re, LANE_QUBITS, steer)
        im = swap_bits(im, LANE_QUBITS, steer)
    for j in range(int(scal[0])):
        kind = int(scal[4 + j])
        idx = int(scal[4 + cap_steps + j])
        if kind == 0:
            a, b = a_tab[idx], b_tab[idx]
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


def run_block(scal: Sequence[int], re: torch.Tensor, im: torch.Tensor,
              a_tab: torch.Tensor, b_tab: torch.Tensor,
              mono_src: torch.Tensor, logt: int, cap_steps: int,
              scratch: Pair = None) -> Pair:
    """Apply one block to the (R2, 256) float32 state pair (re, im).

    On CUDA the result lands in either the input pair or ``scratch`` (a
    pair of the same shape, allocated here when None); the other pair is
    free for the caller's next entry.  ``a_tab``/``b_tab`` are the entry's
    (cap, 256, 256) tables, ``mono_src`` its (cap, 256) int32 gathers.
    """
    if re.device.type == "cpu":
        return run_block_plain(scal, re, im, a_tab, b_tab, mono_src, logt,
                               cap_steps)
    if not re.is_cuda:
        raise ValueError(f"block kernel: unsupported device {re.device}")
    mode = int(scal[1])
    _check_mode(mode)
    rows = re.shape[0]
    if re.shape != (rows, DVIEW) or im.shape != re.shape:
        raise ValueError(f"block kernel: state must be (R2, {DVIEW}), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if a_tab.shape[1:] != (DVIEW, DVIEW) or b_tab.shape != a_tab.shape \
            or mono_src.shape != a_tab.shape[:2]:
        raise ValueError("block kernel: tables must be (cap, 256, 256) and "
                         "mono_src (cap, 256)")
    if scratch is None:
        scratch = (torch.empty_like(re), torch.empty_like(im))
    f32 = torch.float32
    _check_cuda([re, im, *scratch, a_tab, b_tab, mono_src],
                [f32] * 6 + [torch.int32])
    steer = _steer_bit(scal, logt)
    nsteps = int(scal[0])
    if nsteps == 0 and steer < 0:
        return re, im                      # padding row: identity
    lib = build.load()
    stream = torch.cuda.current_stream(re.device).cuda_stream
    slot = DVIEW * DVIEW * 4               # bytes per table slot
    a0, b0, m0 = a_tab.data_ptr(), b_tab.data_ptr(), mono_src.data_ptr()
    total = rows * DVIEW
    src, dst = (re, im), scratch

    def gather(swap_a, swap_b, col_src=None, cs=None):
        return lib.qsim_gather_step(
            src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
            dst[1].data_ptr(), total, swap_a, swap_b, steer, col_src, cs,
            stream)

    if nsteps == 0:                        # prologue-only block
        build.check(lib, gather(-1, -1), "block kernel (prologue)")
        run_block.launches += 1
        return dst
    for j in range(nsteps):
        kind = int(scal[4 + j])
        idx = int(scal[4 + cap_steps + j])
        if kind == 0:
            rc = lib.qsim_mat_step(
                src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                dst[1].data_ptr(), a0 + idx * slot, b0 + idx * slot, rows,
                steer, stream)
        elif kind <= logt:
            rc = gather(LANE_QUBITS, LANE_QUBITS + kind)
        elif kind == logt + 1:
            rc = gather(idx, LANE_QUBITS)
        elif kind == logt + 2:
            rc = gather(-1, -1, m0 + idx * DVIEW * 4, b0 + idx * slot)
        else:
            raise ValueError(f"unknown step kind {kind} (logt = {logt})")
        build.check(lib, rc, f"block kernel (step kind {kind})")
        run_block.launches += 1
        steer = -1
        src, dst = dst, src
    return src


run_block.launches = 0
