"""Split re/im state helpers on torch tensors.

Like the JAX package (and the reference's split ``vr``/``vi`` arrays), the
state is a pair of real float32 tensors ``(re, im)`` over the flat 2^n
index, qubit k = bit k (little-endian).  Every constructor takes an
explicit ``device``; nothing here moves data between devices implicitly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def initial_state_parts(num_qubits: int, dtype=torch.float32,
                        device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """|0...0> as (re, im) tensors on ``device``."""
    size = 1 << num_qubits
    re = torch.zeros(size, dtype=dtype, device=device)
    re[0] = 1.0
    im = torch.zeros(size, dtype=dtype, device=device)
    return re, im


def split_state(v: np.ndarray, dtype=torch.float32,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex host vector -> (re, im) tensors on ``device``."""
    v = np.asarray(v)
    re = torch.as_tensor(np.ascontiguousarray(v.real)).to(device=device, dtype=dtype)
    im = torch.as_tensor(np.ascontiguousarray(v.imag)).to(device=device, dtype=dtype)
    return re, im


def _to_host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.is_cuda:
        # through page-locked memory: a pageable copy runs at a fraction of
        # the link's rate, and torch caches the pinned buffers across calls
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        x = host
    return x.cpu().numpy()


def join_state(re, im) -> np.ndarray:
    """(re, im) tensors or arrays on any device -> one complex host vector.

    The parts are written straight into the complex output (the same values
    as ``re + 1j * im`` cast down, without the complex128 temporary)."""
    re = _to_host(re)
    im = _to_host(im)
    out = np.empty(re.shape, np.complex64 if re.dtype == np.float32
                   else np.complex128)
    out.real = re
    out.imag = im
    return out
