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


# Widths the dense (2,)*n transpose handles; above, bit transpositions.
# (torch's TensorIterator takes at most 25 dims, so no view here is wider.)
DENSE_UNPERMUTE_MAX_QUBITS = 14


def unpermute_axes(perm) -> list:
    """Transpose axes that undo a qubit relabeling on a (2,)*n tensor.

    ``perm[q]`` = current bit position of original qubit q (see
    passes.permute.unpermute_state — this is its device-side twin).
    """
    n = len(perm)
    inv = np.argsort(perm)
    src_axis_of_orig = {int(inv[b]): n - 1 - b for b in range(n)}
    return [src_axis_of_orig[n - 1 - j] for j in range(n)]


def unpermute_device(re: torch.Tensor, im: torch.Tensor, perm):
    """Undo a qubit relabeling on the state's own device.

    Up to DENSE_UNPERMUTE_MAX_QUBITS one transpose of the (2,)*n view.
    Above, the permutation decomposes into at most n exact bit
    transpositions (the JAX package's sequence), each one rank-5 reshape,
    ``transpose`` and copy: an index permutation is exact in any dtype, so
    the JAX package's permutation matmuls are not needed here.
    """
    n = len(perm)
    if n <= DENSE_UNPERMUTE_MAX_QUBITS:
        axes = unpermute_axes(perm)

        def f(x):
            return x.reshape((2,) * n).permute(axes).reshape(-1)

        return f(re), f(im)

    # position -> original qubit currently there (state given in the
    # relabeled basis: original q sits at position perm[q])
    inv = np.argsort(np.asarray(perm))
    qubit_at = [int(inv[p]) for p in range(n)]
    pos_of = [int(p) for p in np.asarray(perm)]
    for q in range(n):
        p = pos_of[q]
        if p == q:
            continue
        re, im = _swap_bits_device(re, im, q, p, n)
        ql = qubit_at[q]
        qubit_at[q], qubit_at[p] = q, ql
        pos_of[q], pos_of[ql] = q, p
    return re, im


def _swap_bits_device(re: torch.Tensor, im: torch.Tensor, a: int, b: int,
                      n: int):
    """Exchange bits a and b (a < b) of the basis index of (2^n,) tensors:
    one transposed copy of the (hi, 2, mid, 2, lo) view each."""
    assert a < b
    shape = (1 << (n - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)

    def f(x):
        return x.reshape(shape).transpose(1, 3).reshape(-1)

    return f(re), f(im)
