"""Copy-bandwidth probe kernels: device memory to device memory.

Replaces ``scripts/dma_probe.py``'s three Pallas copies (TPU kernel 11):
``grid_copy`` (a grid of row tiles), ``stream_copy`` (a W-deep windowed
stream through on-chip memory, the skeleton of a streaming block kernel)
and ``hbm_direct`` (block DMAs that bounce through no registers).  Each is a
kernel of ``csrc/copy_probe.cu``, written by hand for the card:

* ``grid_copy``   one CTA per T-row tile and operand, 128-bit loads and
  stores through registers;
* ``stream_copy`` persistent CTAs, T-row tiles brought into a W-stage
  shared-memory ring by TMA bulk copies, written out by the threads;
* ``hbm_direct``  persistent CTAs, TMA bulk copies both ways (global ->
  shared -> global), W stages.

Operands are 1, 2 or 4 contiguous float32 matrices of one shape: the
state's (R2, 256) re component, the (re, im) pair, or the four (R2, 128)
column halves of the in-place engine.  A tile is T rows of one operand.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version (``dst.copy_(src)``, ``copy_plain``) for CPU tensors; any other
device raises.  ``<wrapper>.launches`` counts kernel launches.  A copy of
the card's own (``cudaMemcpyAsync``, torch ``copy_``) is the library
yardstick only; no route here uses it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import telemetry
from . import build

MAX_SMEM = 227 * 1024       # shared memory one CTA can hold (H100)
MAX_TILE = 1 << 20          # bytes one mbarrier phase can count
MAX_STAGES = 16

Operands = Tuple[torch.Tensor, ...]


def copy_plain(srcs: Sequence[torch.Tensor],
               out: Optional[Sequence[torch.Tensor]] = None) -> Operands:
    """``dst.copy_(src)`` for each operand (new tensors when ``out`` is
    None), on any device."""
    if out is None:
        return tuple(s.clone() for s in srcs)
    for s, d in zip(srcs, out):
        d.copy_(s)
    return tuple(out)


def _check(srcs, out, tile_rows: int, what: str) -> int:
    """Validate the operands; the tile's bytes."""
    if len(srcs) not in (1, 2, 4) or (out is not None
                                      and len(out) != len(srcs)):
        raise ValueError(f"{what}: 1, 2 or 4 operands (and as many outputs), "
                         f"got {len(srcs)}")
    rows, width = srcs[0].shape if srcs[0].dim() == 2 else (0, 0)
    if rows == 0 or tile_rows <= 0 or rows % tile_rows:
        raise ValueError(f"{what}: operands are 2-D with rows a multiple of "
                         f"the tile's {tile_rows}, got "
                         f"{tuple(srcs[0].shape)}")
    for t in (*srcs, *(out or ())):
        if t.shape != srcs[0].shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != srcs[0].device:
            raise ValueError(
                f"{what}: operands must be contiguous float32 "
                f"{tuple(srcs[0].shape)} tensors on {srcs[0].device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (width * 4) % 16:
        raise ValueError(f"{what}: rows of 16-byte multiples, got {width}")
    return tile_rows * width * 4


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch(fn, srcs, out, tile_rows: int, stages: Optional[int],
            what: str) -> Operands:
    tile = _check(srcs, out, tile_rows, what)
    if stages is not None and not (
            (2 if fn is hbm_direct else 1) <= stages <= MAX_STAGES
            and stages * tile <= MAX_SMEM and tile < MAX_TILE):
        raise ValueError(
            f"{what}: {stages} stages of {tile} bytes; it takes "
            f"{2 if fn is hbm_direct else 1}..{MAX_STAGES} stages of under "
            f"{MAX_TILE} bytes that fit a CTA's {MAX_SMEM} bytes of shared "
            "memory")
    if srcs[0].device.type == "cpu":
        return copy_plain(srcs, out)
    if not srcs[0].is_cuda:
        raise ValueError(f"{what}: unsupported device {srcs[0].device}")
    if out is None:
        out = tuple(torch.empty_like(s) for s in srcs)
    lib = build.load()
    stream = torch.cuda.current_stream(srcs[0].device).cuda_stream
    nbytes = srcs[0].numel() * 4
    src_p, dst_p = _pointers(srcs), _pointers(out)
    if stages is None:
        rc = lib.qsim_copy_grid(src_p, dst_p, len(srcs), nbytes, tile, stream)
    else:
        entry = (lib.qsim_copy_direct if fn is hbm_direct
                 else lib.qsim_copy_stream)
        rc = entry(src_p, dst_p, len(srcs), nbytes, tile, stages, stream)
    build.check(lib, rc, what)
    fn.launches += 1
    return tuple(out)


@telemetry.counted
def grid_copy(srcs: Sequence[torch.Tensor], tile_rows: int,
              out: Optional[Sequence[torch.Tensor]] = None) -> Operands:
    """Copy 1, 2 or 4 operands, one CTA per ``tile_rows``-row tile of
    each; the copies land in ``out`` (allocated when None)."""
    return _launch(grid_copy, srcs, out, tile_rows, None, "grid_copy")


@telemetry.counted
def stream_copy(srcs: Sequence[torch.Tensor], tile_rows: int, stages: int,
                out: Optional[Sequence[torch.Tensor]] = None) -> Operands:
    """Copy through a ``stages``-deep shared-memory ring of
    ``tile_rows``-row tiles: TMA loads, stores from the threads."""
    return _launch(stream_copy, srcs, out, tile_rows, stages, "stream_copy")


@telemetry.counted
def hbm_direct(srcs: Sequence[torch.Tensor], tile_rows: int, stages: int,
               out: Optional[Sequence[torch.Tensor]] = None) -> Operands:
    """Copy by TMA bulk copies both ways, ``stages`` (>= 2) tiles of
    ``tile_rows`` rows in flight per CTA."""
    return _launch(hbm_direct, srcs, out, tile_rows, stages, "hbm_direct")


def reset_launches() -> None:
    """Set the launch counts of the three copy kernels to 0."""
    for fn in (grid_copy, stream_copy, hbm_direct):
        fn.launches = 0


reset_launches()
