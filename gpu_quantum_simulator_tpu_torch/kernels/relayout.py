"""Relayout kernel wrapper: permute the state's row-block bits in one pass.

Replaces ``gpu_quantum_simulator_tpu/engine/prefetch.py``
``get_relayout_kernel`` (scal mode 3 entries).  The (R2, 256) state is
cut into R2 / tr row blocks of ``tr`` rows; output block i is input block
src(i), where bit a of src(i) is bit ``sigma[a]`` of i.

``run_relayout`` launches ``csrc/relayout.cu`` for a CUDA state and runs
``run_relayout_plain`` — the same copy in plain torch — for a CPU state.
Any other device raises.  ``run_relayout.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import build

DVIEW = 256
MAX_SLOTS = 24   # RELAYOUT_SLOTS: sigma entries the kernel takes by value

Pair = Tuple[torch.Tensor, torch.Tensor]


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
