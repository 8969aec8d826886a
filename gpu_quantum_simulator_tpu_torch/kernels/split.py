"""In-place split-state kernels: a prefetch block and the cross-tile swap
on the state's own four column halves.

Replaces ``gpu_quantum_simulator_tpu/engine/prefetch.py``
``get_split_kernels`` (the aliased block kernel over ``_steps_loop_halves``
and the pair-grid ``xswap`` kernel) and ``get_stream_split_kernel`` (whose
pair mode reads a block's input through the pending cross-tile swap).  The
state is four (R2, 128) float32 tensors ``(re0, re1, im0, im1)``: columns
0..127 (h0) and 128..255 (h1) of the (R2, 256) re and im of the flat
engine, so flat bit 7 is the half.  Every function here OVERWRITES those
four tensors and returns them; none allocates anything of state size on a
card (the in-place engine exists to hold no second state buffer).

A block is one row of the planner's ``scal`` table, as for the flat block
kernel (kernels/block.py): mode 0 plain, mode 1 PAIR MODE — the pending
cross-tile swap (flat bit 7 <-> row bit ``logt + scal[3]``) is read through
by the block's first launch and costs no pass of its own (a block with no
steps still performs the swap).  Step kinds and precision rungs are those
of the flat kernel, and so is the arithmetic: on a card the fp32 and "high"
mat steps give the flat kernels' values bit for bit.

``run_split_block`` and ``run_xswap`` launch ``csrc/split_block.cu`` for
CUDA tensors (one launch per step) and run the plain torch versions
``run_split_block_plain`` and ``run_xswap_plain`` for CPU tensors; any
other device raises.  ``run_split_block.launches`` counts launches by kind:
``mat``, ``mat_high``, ``mat_default`` (the "high" kernel's "default"
instantiation), ``gather`` (tswap, perm, mono) and ``pair`` (the first
launch of a mode-1 block, whichever step it runs);
``run_xswap.launches`` counts the pair swaps.  The telemetry counters
``inplace_mat_steps`` and ``inplace_mono_steps`` count the blocks' mat and
mono steps, the plain versions' too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import telemetry
from . import build
from .block import (DVIEW, HIGH_SLOT_WORDS, SPLIT_RUNGS, _check_rung,
                    check_high_tables, run_block_plain, split_tables)

LANES = 128
LAUNCH_KINDS = ("mat", "mat_high", "mat_default", "gather", "pair")
HIGH_SYNC_GROUPS = 64      # CTA groups the "high" step's counters serve

Halves = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def split_halves(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two contiguous (R2, 128) column halves of a flat or (R2, 256)
    component."""
    x = x.reshape(-1, DVIEW)
    return x[:, :LANES].contiguous(), x[:, LANES:].contiguous()


def join_component(h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """(R2, 256) component from its two halves (one new tensor)."""
    return torch.cat([h0, h1], dim=1)


def _check_halves(halves: Halves, what: str) -> int:
    rows = halves[0].shape[0]
    if len(halves) != 4 or any(h.shape != (rows, LANES) for h in halves):
        raise ValueError(f"{what}: the state is four (R2, {LANES}) halves, "
                         f"got {[tuple(h.shape) for h in halves]}")
    return rows


def _check_block_mode(mode: int) -> None:
    if mode not in (0, 1):
        raise ValueError(
            f"split block mode {mode}: in-place blocks are plain (0) or pair "
            "mode (1); 2 is the pair swap (run_xswap), 3 the in-place "
            "relayout (kernels/relayout.py), 5 never occurs in place, and "
            "the mesh gswap (4) is an entry of the sharded chain "
            "(parallel/sharded_prefetch.py)")


def run_xswap_plain(halves: Halves, row_bit: int) -> Halves:
    """h1[r] <-> h0[r | 2^row_bit] for every row r with that bit clear, re
    and im: flat bits 7 and 8 + row_bit exchanged.  Overwrites ``halves``."""
    rows = _check_halves(halves, "xswap")
    if not 0 <= row_bit < rows.bit_length() - 1:
        raise ValueError(f"xswap: row bit {row_bit} outside {rows} rows")
    shape = (rows >> (row_bit + 1), 2, 1 << row_bit, LANES)
    for h0, h1 in (halves[:2], halves[2:]):
        up = h1.view(shape)[:, 0]
        dn = h0.view(shape)[:, 1]
        tmp = up.clone()
        up.copy_(dn)
        dn.copy_(tmp)
    return halves


def _cuda_halves(halves: Halves, what: str) -> int:
    rows = _check_halves(halves, what)
    dev = halves[0].device
    for t in halves:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: expected four contiguous float32 "
                             "halves on one CUDA device")
    return rows


_SYNC: dict = {}


def _high_sync(dev: torch.device, stream: int) -> torch.Tensor:
    """The "high" in-place step's counters for launches on ``stream`` (a
    CUDA stream handle) of ``dev``: two int32 a CTA group, zero between
    launches (the kernel leaves them zero).  One buffer per stream, so that
    steps in flight on two streams, or a captured graph replayed beside a
    live run, never count on the same ints."""
    key = (dev, stream)
    if key not in _SYNC:
        _SYNC[key] = torch.zeros(2 * HIGH_SYNC_GROUPS, dtype=torch.int32,
                                 device=dev)
    return _SYNC[key]


@telemetry.counted
def run_xswap(halves: Halves, row_bit: int) -> Halves:
    """The cross-tile pair swap (scal mode 2) in the state's own buffers."""
    dev = halves[0].device
    if dev.type == "cpu":
        return run_xswap_plain(halves, row_bit)
    if not halves[0].is_cuda:
        raise ValueError(f"xswap kernel: unsupported device {dev}")
    rows = _cuda_halves(halves, "xswap kernel")
    lib = build.load()
    rc = lib.qsim_split_swap_rows(
        *(t.data_ptr() for t in halves), rows, int(row_bit),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "xswap kernel")
    run_xswap.launches += 1
    return halves


run_xswap.launches = 0


def run_split_block_plain(scal: Sequence[int], halves: Halves,
                          a_tab: torch.Tensor, b_tab: torch.Tensor,
                          mono_src: torch.Tensor, logt: int, cap_steps: int,
                          precision: str = "highest") -> Halves:
    """The block in plain torch: the halves joined into the flat (R2, 256)
    pair, the flat plain block on it (``run_block_plain``: pair mode is its
    steered input map, the same index exchange), and the result written
    back into ``halves``.  The joined pair is a temporary of state size:
    this version serves CPU tensors and comparisons, not the card's path."""
    _check_halves(halves, "split block")
    _check_block_mode(int(scal[1]))
    if int(scal[0]) == 0 and int(scal[1]) == 0:
        return halves                      # padding row: identity
    re, im = run_block_plain(
        scal, join_component(*halves[:2]), join_component(*halves[2:]),
        a_tab, b_tab, mono_src, logt, cap_steps, precision=precision)
    for h, x in zip(halves, (re[:, :LANES], re[:, LANES:],
                             im[:, :LANES], im[:, LANES:])):
        h.copy_(x)
    return halves


@telemetry.counted
def run_split_block(scal: Sequence[int], halves: Halves, a_tab: torch.Tensor,
                    b_tab: torch.Tensor, mono_src: torch.Tensor, logt: int,
                    cap_steps: int, precision: str = "highest",
                    high_tables: Optional[torch.Tensor] = None) -> Halves:
    """Apply one block to the four halves in place and return them.

    ``a_tab``/``b_tab`` are the entry's (cap, 256, 256) tables, ``mono_src``
    its (cap, 256) int32 gathers and ``high_tables`` its ``split_tables``
    for the "high" and "default" rungs (computed here when None; checked on every device
    when given); a block without steps reads no table, and they may then be
    None.

    Counts the block's steps by kind, on every device: ``inplace_mat_steps``
    (kind 0) and ``inplace_mono_steps`` (kind ``logt + 2``)."""
    if high_tables is not None:
        check_high_tables(high_tables, a_tab.shape[0], "split block kernel")
    kinds = [int(scal[4 + j]) for j in range(int(scal[0]))]
    telemetry.count("inplace_mat_steps", kinds.count(0))
    telemetry.count("inplace_mono_steps", kinds.count(logt + 2))
    dev = halves[0].device
    if dev.type == "cpu":
        return run_split_block_plain(scal, halves, a_tab, b_tab, mono_src,
                                     logt, cap_steps, precision)
    if not halves[0].is_cuda:
        raise ValueError(f"split block kernel: unsupported device {dev}")
    mode = int(scal[1])
    _check_block_mode(mode)
    _check_rung(precision)
    rows = _cuda_halves(halves, "split block kernel")
    nsteps = int(scal[0])
    # the pending swap's row bit (flat bit - 8), read through by the first
    # launch only
    pair = logt + int(scal[3]) if mode == 1 else -1
    if pair >= 0 and (2 << pair) > rows:
        raise ValueError(f"split block kernel: pair bit {pair} outside "
                         f"{rows} rows")
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in halves]
    counts = run_split_block.launches
    if nsteps == 0:
        if pair >= 0:                      # a block of the swap alone
            rc = lib.qsim_split_swap_rows(*ptrs, rows, pair, stream)
            build.check(lib, rc, "split block kernel (pair swap)")
            counts["pair"] += 1
        return halves                      # else a padding row: identity
    if a_tab.shape[1:] != (DVIEW, DVIEW) or b_tab.shape != a_tab.shape \
            or mono_src.shape != a_tab.shape[:2]:
        raise ValueError("split block kernel: tables must be (cap, 256, 256) "
                         "and mono_src (cap, 256)")
    high = precision in SPLIT_RUNGS and 0 in kinds
    if high and high_tables is None:
        high_tables = split_tables(a_tab, b_tab)
    tensors = [a_tab, b_tab, mono_src] + ([high_tables] if high else [])
    dtypes = [torch.float32, torch.float32, torch.int32, torch.int32]
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"split block kernel: expected contiguous {dt} "
                             f"tables on {dev}, got {t.dtype} on {t.device}")
    slot = DVIEW * DVIEW * 4               # bytes per table slot
    a0, b0, m0 = a_tab.data_ptr(), b_tab.data_ptr(), mono_src.data_ptr()
    for j in range(nsteps):
        kind = int(scal[4 + j])
        idx = int(scal[4 + cap_steps + j])
        if kind == 0 and high:
            what = "mat_" + precision
            rc = lib.qsim_split_mat_step_high(
                *ptrs, high_tables.data_ptr() + idx * HIGH_SLOT_WORDS * 4,
                rows, pair, _high_sync(dev, stream).data_ptr(),
                HIGH_SYNC_GROUPS, int(precision == "high"), stream)
        elif kind == 0:
            what = "mat"
            rc = lib.qsim_split_mat_step(*ptrs, a0 + idx * slot,
                                         b0 + idx * slot, rows, pair, stream)
        elif kind <= logt:
            what = "gather"
            if pair >= 0:
                rc = lib.qsim_split_tswap_pair(*ptrs, rows, kind - 1, pair,
                                               stream)
            else:
                rc = lib.qsim_split_swap_rows(*ptrs, rows, kind - 1, stream)
        elif kind == logt + 1:
            what = "gather"
            rc = lib.qsim_split_row_step(*ptrs, rows, idx, None, None, pair,
                                         stream)
        elif kind == logt + 2:
            what = "gather"
            rc = lib.qsim_split_row_step(*ptrs, rows, -1, m0 + idx * DVIEW * 4,
                                         b0 + idx * slot, pair, stream)
        else:
            raise ValueError(f"unknown step kind {kind} (logt = {logt})")
        build.check(lib, rc, f"split block kernel (step kind {kind})")
        counts["pair" if pair >= 0 else what] += 1
        pair = -1
    return halves


def reset_launches() -> None:
    """Set every launch count of this module's wrappers to 0."""
    run_split_block.launches = dict.fromkeys(LAUNCH_KINDS, 0)
    run_xswap.launches = 0


reset_launches()
