"""Relayout kernel wrapper: permute the state's row-block bits in one pass.

Replaces ``gpu_quantum_simulator_tpu/engine/prefetch.py``
``get_relayout_kernel`` (scal mode 3 entries).  The (R2, 256) state is
cut into R2 / tr row blocks of ``tr`` rows; output block i is input block
src(i), where bit a of src(i) is bit ``sigma[a]`` of i.

``run_relayout`` launches ``csrc/relayout.cu`` for a CUDA state and runs
``run_relayout_plain`` — the same copy in plain torch — for a CPU state.
Any other device raises.  ``run_relayout.launches`` counts kernel launches.

``run_relayout_inplace`` replaces ``get_inplace_relayout_kernel``: the same
permutation inside the four (R2, 128) column halves of the in-place
split-state engine, which has no second buffer to copy into.  There sigma
must be an involution (the planner's ``involution_relayout``), so the
row blocks split into fixed ones and disjoint pairs that are swapped;
``run_relayout_inplace_plain`` does the same swaps in plain torch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from . import build

DVIEW = 256
MAX_SLOTS = 24   # RELAYOUT_SLOTS: sigma entries the kernel takes by value

Pair = Tuple[torch.Tensor, torch.Tensor]
Halves = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
LANES = 128


def relayout_sources(sigma: Sequence[int], nblk: int) -> np.ndarray:
    """src(i) for every output block i (int64[nblk])."""
    i = np.arange(nblk, dtype=np.int64)
    src = np.zeros(nblk, dtype=np.int64)
    for a, s in enumerate(sigma):
        src |= ((i >> int(s)) & 1) << a
    return src


def _geometry(sigma, re: torch.Tensor, tr: int) -> int:
    rows = re.shape[0]
    if re.dim() != 2 or re.shape[1] != DVIEW or rows % tr:
        raise ValueError(f"relayout: state must be (R2, {DVIEW}) with R2 a "
                         f"multiple of tr={tr}, got {tuple(re.shape)}")
    nblk = rows // tr
    if len(sigma) != (nblk - 1).bit_length() or len(sigma) > MAX_SLOTS:
        raise ValueError(f"relayout: sigma needs {(nblk - 1).bit_length()} "
                         f"entries (<= {MAX_SLOTS}), got {len(sigma)}")
    return nblk


def run_relayout_plain(sigma: Sequence[int], re: torch.Tensor,
                       im: torch.Tensor, tr: int) -> Pair:
    """The relayout as a row-block index_select, on any device."""
    nblk = _geometry(sigma, re, tr)
    src = torch.from_numpy(relayout_sources(sigma, nblk)).to(re.device)

    def one(x):
        return x.reshape(nblk, tr * DVIEW)[src].reshape(x.shape)

    return one(re), one(im)


@telemetry.counted
def run_relayout(sigma: Sequence[int], re: torch.Tensor, im: torch.Tensor,
                 tr: int, out: Pair = None) -> Pair:
    """Apply the row-block permutation ``sigma`` to (re, im).

    On CUDA the result is written into ``out`` (allocated when None) and
    returned; the input pair is left as it was."""
    if re.device.type == "cpu":
        return run_relayout_plain(sigma, re, im, tr)
    if not re.is_cuda:
        raise ValueError(f"relayout kernel: unsupported device {re.device}")
    nblk = _geometry(sigma, re, tr)
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    for t in (re, im, *out):
        if (t.device != re.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != re.shape):
            raise ValueError("relayout kernel: expected four contiguous "
                             "float32 (R2, 256) tensors on one CUDA device")
    lib = build.load()
    sig = np.ascontiguousarray(np.asarray(sigma, dtype=np.int32))
    rc = lib.qsim_relayout(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        nblk, tr, sig.ctypes.data, len(sig),
        torch.cuda.current_stream(re.device).cuda_stream)
    build.check(lib, rc, "relayout kernel")
    run_relayout.launches += 1
    return out


run_relayout.launches = 0


def _inplace_geometry(sigma, halves: Halves, tr: int) -> int:
    rows = halves[0].shape[0]
    if len(halves) != 4 or any(h.shape != (rows, LANES) for h in halves) \
            or rows % tr:
        raise ValueError(f"in-place relayout: the state is four (R2, {LANES}) "
                         f"halves with R2 a multiple of tr={tr}, got "
                         f"{[tuple(h.shape) for h in halves]}")
    nblk = rows // tr
    sigma = [int(s) for s in sigma]
    if len(sigma) != (nblk - 1).bit_length() or len(sigma) > MAX_SLOTS:
        raise ValueError(f"in-place relayout: sigma needs "
                         f"{(nblk - 1).bit_length()} entries (<= {MAX_SLOTS}),"
                         f" got {len(sigma)}")
    if sorted(sigma) != list(range(len(sigma))) \
            or any(sigma[s] != a for a, s in enumerate(sigma)):
        raise ValueError(f"in-place relayout: sigma {sigma} is not an "
                         "involution; only disjoint block swaps run in the "
                         "state's own buffers")
    return nblk


def run_relayout_inplace_plain(sigma: Sequence[int], halves: Halves,
                               tr: int) -> Halves:
    """The in-place relayout in plain torch: every pair of row blocks
    (i, src(i)) with i < src(i) exchanged in each half, fixed blocks left
    alone.  Overwrites and returns ``halves``."""
    nblk = _inplace_geometry(sigma, halves, tr)
    src = relayout_sources(sigma, nblk)
    lo = np.nonzero(src > np.arange(nblk))[0]
    if len(lo):
        i = torch.from_numpy(lo).to(halves[0].device)
        j = torch.from_numpy(src[lo]).to(halves[0].device)
        for h in halves:
            blocks = h.view(nblk, tr * LANES)
            vi, vj = blocks[i], blocks[j]
            blocks[i] = vj
            blocks[j] = vi
    return halves


@telemetry.counted
def run_relayout_inplace(sigma: Sequence[int], halves: Halves,
                         tr: int) -> Halves:
    """Apply the involutive row-block permutation ``sigma`` inside the four
    halves; they are overwritten and returned."""
    dev = halves[0].device
    if dev.type == "cpu":
        return run_relayout_inplace_plain(sigma, halves, tr)
    if not halves[0].is_cuda:
        raise ValueError(f"in-place relayout kernel: unsupported device {dev}")
    nblk = _inplace_geometry(sigma, halves, tr)
    for t in halves:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("in-place relayout kernel: expected four "
                             "contiguous float32 halves on one CUDA device")
    lib = build.load()
    sig = np.ascontiguousarray(np.asarray(sigma, dtype=np.int32))
    rc = lib.qsim_relayout_inplace(
        *(t.data_ptr() for t in halves), nblk, tr, sig.ctypes.data, len(sig),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "in-place relayout kernel")
    run_relayout_inplace.launches += 1
    return halves


run_relayout_inplace.launches = 0
