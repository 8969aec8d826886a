"""Kernel 8: a chunk of fused ops in one cooperative CUDA launch.

``csrc/vmem_chunk.cu`` replaces the JAX package's ``engine/vmem.py``
``_build_vmem_chunk``: up to ``CHUNK_OPS`` ops, each a row shuffle, a
(2^n / D, D) @ (D, D) complex product (D = 128 << kh, kh <= 2) and the
inverse shuffle, applied in order to the (R, 128) float32 pair, with a
grid-wide barrier between ops and the state held in L2.  ``vmem_tables``
lays out a chunk's device tables; ``vmem_chunk`` launches the kernel for
a CUDA state and runs ``vmem_chunk_plain`` (torch row shuffles and four
real fp32 matmuls per op, as the JAX kernel's four dots) for a CPU state;
any other device raises.  ``vmem_chunk.launches`` counts launches and
``vmem_chunk.last_grid`` is the last launch's grid size.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from . import build
from .wide import LANES, ieee_fp32, row_shuffles

LANE_QUBITS = 7
TILE_ROWS, TILE_COLS = 32, 64   # a CTA's output tile (csrc/vmem_chunk.cu)

Pair = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class VmemTables:
    """One chunk's device tables.

    ``mats``: flat float32, per op [Mt_re, Mt_im], each (D, D) with
    Mt = M^T (the JAX package's storage: out = A @ Mt).  ``desc``: (ops, 4)
    int32 rows (kh, b1, b2, offset of Mt_re in ``mats``; b1, b2 are the row
    bits, 0 where absent).  ``steps``: the same per op on the host, as
    (row_bits, offset, D).  ``max_tiles``: the most kernel tiles an op of
    the chunk has.
    """

    num_qubits: int
    mats: torch.Tensor
    desc: torch.Tensor
    steps: List[tuple]
    max_tiles: int


def vmem_tables(specs: Sequence[tuple], num_qubits: int,
                device) -> VmemTables:
    """Tables for a chunk from ``specs`` = [(row_bits, M_re, M_im)], each M
    (D, D) numpy in the superset ordering of engine/wide.py ``_op_spec``
    (D-index bit 7 + j <-> row_bits[j], ascending)."""
    parts, desc, steps, off, max_tiles = [], [], [], 0, 1
    for row_bits, bre, bim in specs:
        kh = len(row_bits)
        if kh > 2:
            raise ValueError(
                "vmem program requires blocks with <= 2 high qubits")
        D = LANES << kh
        if bre.shape != (D, D) or bim.shape != (D, D):
            raise ValueError(f"kh = {kh} needs ({D}, {D}) matrices")
        b = list(row_bits) + [0] * (2 - kh)
        desc.append((kh, b[0], b[1], off))
        steps.append((tuple(row_bits), off, D))
        parts += [np.asarray(bre, np.float32).T.ravel(),
                  np.asarray(bim, np.float32).T.ravel()]
        off += 2 * D * D
        rows = (1 << num_qubits) // D
        max_tiles = max(max_tiles,
                        -(-rows // TILE_ROWS) * (D // TILE_COLS))
    if off >= 1 << 31:
        raise ValueError("a chunk's tables must hold < 2^31 floats")
    mats = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return VmemTables(
        num_qubits,
        torch.from_numpy(np.ascontiguousarray(mats, np.float32)).to(device),
        torch.tensor(desc, dtype=torch.int32, device=device).reshape(-1, 4),
        steps, max_tiles)


def vmem_chunk_plain(re: torch.Tensor, im: torch.Tensor,
                     tables: VmemTables) -> Pair:
    """The chunk in plain torch, on any device: for each op the row
    shuffle, o_re = a_re @ Mt_re - a_im @ Mt_im, o_im = a_im @ Mt_re +
    a_re @ Mt_im (IEEE fp32), the inverse shuffle."""
    R = re.shape[0]
    with ieee_fp32():
        for row_bits, off, D in tables.steps:
            mret = tables.mats[off : off + D * D].view(D, D)
            mimt = tables.mats[off + D * D : off + 2 * D * D].view(D, D)
            fwd, bwd = row_shuffles(row_bits, R)
            a_re, a_im = fwd(re), fwd(im)
            re = bwd(a_re @ mret - a_im @ mimt)
            im = bwd(a_im @ mret + a_re @ mimt)
    return re, im


def _check_pair(pair, shape, dev, what):
    for t in pair:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"vmem kernel: {what} must be contiguous "
                             f"float32 {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


@telemetry.counted
def vmem_chunk(re: torch.Tensor, im: torch.Tensor, tables: VmemTables,
               scratch: Optional[Pair] = None) -> Pair:
    """Apply the chunk's ops in order to the (R, 128) pair.

    On the card the state ping-pongs between (re, im) and ``scratch``
    (allocated when None): the returned pair is the input pair when the
    chunk has an even number of ops, ``scratch`` when it has an odd one,
    and the other pair holds garbage.  On the CPU it is a new pair.
    """
    if re.device.type == "cpu":
        return vmem_chunk_plain(re, im, tables)
    if not re.is_cuda:
        raise ValueError(f"vmem kernel: unsupported device {re.device}")
    nops = len(tables.steps)
    shape = (1 << (tables.num_qubits - LANE_QUBITS), LANES)
    if nops == 0:
        return re, im
    if scratch is None:
        scratch = (torch.empty_like(re), torch.empty_like(im))
    _check_pair((re, im), shape, re.device, "state")
    _check_pair(scratch, shape, re.device, "scratch")
    if tables.mats.device != re.device or tables.desc.device != re.device:
        raise ValueError("vmem kernel: tables must be on the state's device")
    lib = build.load()
    grid = ctypes.c_int(0)
    rc = lib.qsim_vmem_chunk(
        re.data_ptr(), im.data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), tables.mats.data_ptr(),
        tables.desc.data_ptr(), nops, tables.num_qubits, tables.max_tiles,
        ctypes.byref(grid), torch.cuda.current_stream(re.device).cuda_stream)
    build.check(lib, rc, f"vmem kernel ({nops} ops, n = "
                         f"{tables.num_qubits})")
    vmem_chunk.launches += 1
    vmem_chunk.last_grid = grid.value
    return (re, im) if nops % 2 == 0 else scratch


def reset_launches() -> None:
    """Set the launch count of ``vmem_chunk`` to 0."""
    vmem_chunk.launches = 0


reset_launches()
vmem_chunk.last_grid = 0
