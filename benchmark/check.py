"""The comparisons that decide ``correct``.

Every number here compares what the timed path produced with the plain
reference (``references/``), which recomputed the state from the same gate
lists.  The program's outputs come in three forms, all read as they are:

- a host vector of 2^n complex amplitudes (``Simulator.run_detailed``);
- a flat (re, im) pair of float32 tensors on the card (``run_device``),
  or, for a sharded state, a pair of shard lists whose shard s is slice s
  of the flat state;
- the in-place engine's four (2^(n-8), 128) column halves
  (re0, re1, im0, im1): basis index (row << 8) | column, the second half
  holding columns 128..255 (``run_device_halves``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS = 1 << 16            # rows of 256 amplitudes compared at a time


def _chunks(out, device):
    """(start, complex128 block on ``device``) over the flat basis order."""
    if isinstance(out, np.ndarray):
        flat = out.reshape(-1)
        step = ROWS * 256
        for s in range(0, flat.size, step):
            yield s, torch.from_numpy(flat[s:s + step]).to(device).to(
                torch.complex128)
        return
    if len(out) == 2 and isinstance(out[0], (list, tuple)):
        off = 0
        for r, i in zip(*out):
            for s, block in _chunks((r, i), device):
                yield off + s, block
            off += r.numel()
        return
    if len(out) == 2:
        re, im = (t.reshape(-1) for t in out)
        step = ROWS * 256
        for s in range(0, re.numel(), step):
            yield s, torch.complex(re[s:s + step].to(device, torch.float64),
                                   im[s:s + step].to(device, torch.float64))
        return
    re0, re1, im0, im1 = out
    for r in range(0, re0.shape[0], ROWS):
        rows = slice(r, r + ROWS)
        re = torch.cat([re0[rows], re1[rows]], dim=1).reshape(-1)
        im = torch.cat([im0[rows], im1[rows]], dim=1).reshape(-1)
        yield r * 256, torch.complex(re.to(device, torch.float64),
                                     im.to(device, torch.float64))


def size_of(out) -> int:
    """Amplitudes in an output of any of the three forms."""
    if isinstance(out, np.ndarray):
        return out.size
    if len(out) == 2 and isinstance(out[0], (list, tuple)):
        return sum(t.numel() for t in out[0])
    if len(out) == 2:
        return out[0].numel()
    return 2 * out[0].numel()      # the re halves hold one part each


def amp_err(out, ref) -> float:
    """||psi - psi_ref|| / ||psi_ref|| over every amplitude; inf where the
    output has the wrong size or a non-finite entry."""
    if size_of(out) != ref.numel():
        return math.inf
    diff = 0.0
    for s, block in _chunks(out, ref.device):
        d = block - ref[s:s + block.numel()]
        diff += float(torch.sum(d.real * d.real + d.imag * d.imag))
    norm = sum(float(ref[s:s + ROWS * 256].abs().square().sum())
               for s in range(0, ref.numel(), ROWS * 256))
    err = math.sqrt(diff / norm)
    return err if math.isfinite(err) else math.inf


def shots_bad(shots, num_qubits: int, num_shots: int) -> int:
    """Shots missing, extra or outside [0, 2^n): 0 for a sound answer."""
    shots = np.asarray(shots)
    if shots.ndim != 1 or not np.issubdtype(shots.dtype, np.integer):
        return max(num_shots, 1)
    outside = int(np.count_nonzero((shots < 0) | (shots >= (1 << num_qubits))))
    return abs(shots.size - num_shots) + outside


def shots_z(shots, ref) -> float:
    """How far the shots' mean reference probability lies from what shots
    drawn from |psi_ref|^2 give, in standard errors.

    With p the reference distribution and x drawn from it, N p(x) has mean
    N sum p^2 and variance N^2 (sum p^3 - (sum p^2)^2); the mean over S
    shots has that variance over S.  Shots drawn from another distribution
    (altered indices, a wrong state, a biased sampler) move the mean by many
    standard errors."""
    total = p2 = p3 = 0.0
    for s in range(0, ref.numel(), ROWS * 256):
        p = ref[s:s + ROWS * 256].abs().square()
        total += float(p.sum())
        p2 += float(torch.sum(p * p))
        p3 += float(torch.sum(p * p * p))
    p2, p3 = p2 / total ** 2, p3 / total ** 3
    idx = torch.as_tensor(np.asarray(shots, dtype=np.int64), device=ref.device)
    seen = float(ref[idx].abs().square().mean()) / total
    var = max(p3 - p2 * p2, 0.0) / idx.numel()
    if var == 0.0:
        return 0.0 if seen == p2 else math.inf
    return abs(seen - p2) / math.sqrt(var)
