"""Split re/im state helpers and gate-application primitives on torch.

Like the JAX package (and the reference's split ``vr``/``vi`` arrays), the
state is a pair of real float32 tensors ``(re, im)`` over the flat 2^n
index, qubit k = bit k (little-endian).  Every constructor takes a
``device``, the card unless the caller asks for the CPU; nothing here
moves data between devices implicitly.

The primitives ``apply_1q``, ``apply_2q``, ``apply_cnot`` and ``apply_kq``
are the JAX package's ``ops/apply.py`` in torch calls (the megakernel arm,
engine/megakernel.py): reshapes, ``einsum``/``matmul`` in IEEE fp32 (TF32
off whatever the process-wide setting, as the JAX package's
``precision="highest"``) and exact copies.  Qubit indices are Python ints;
gate matrices may be numpy arrays or tensors and are moved to the state's
device and dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ir.oplist import expand_unitary
from ..kernels.wide import ieee_fp32


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request on a host without a
    card raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' for the plain torch path")
    return device


def initial_state_parts(num_qubits: int, dtype=torch.float32,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """|0...0> as (re, im) tensors on ``device``."""
    device = resolve_device(device)
    size = 1 << num_qubits
    re = torch.zeros(size, dtype=dtype, device=device)
    re[0] = 1.0
    im = torch.zeros(size, dtype=dtype, device=device)
    return re, im


def split_state(v: np.ndarray, dtype=torch.float32,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex host vector -> (re, im) tensors on ``device``."""
    device = resolve_device(device)
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

    for q, p in bit_transpositions(perm):
        re, im = _swap_bits_device(re, im, q, p, n)
    return re, im


def bit_transpositions(perm) -> list:
    """The exact bit exchanges (a, b), a < b, that undo a qubit relabeling
    when applied in order (the JAX package's sequence; ``perm`` as in
    ``unpermute_device``)."""
    n = len(perm)
    # position -> original qubit currently there (state given in the
    # relabeled basis: original q sits at position perm[q])
    inv = np.argsort(np.asarray(perm))
    qubit_at = [int(inv[p]) for p in range(n)]
    pos_of = [int(p) for p in np.asarray(perm)]
    out = []
    for q in range(n):
        p = pos_of[q]
        if p == q:
            continue
        out.append((q, p))
        ql = qubit_at[q]
        qubit_at[q], qubit_at[p] = q, ql
        pos_of[q], pos_of[ql] = q, p
    return out


def _swap_bits_device(re: torch.Tensor, im: torch.Tensor, a: int, b: int,
                      n: int):
    """Exchange bits a and b (a < b) of the basis index of (2^n,) tensors:
    one transposed copy of the (hi, 2, mid, 2, lo) view each."""
    assert a < b
    shape = (1 << (n - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)

    def f(x):
        return x.reshape(shape).transpose(1, 3).reshape(-1)

    return f(re), f(im)


LANE_QUBITS = 7   # low qubits on the 128-wide last dim of the (R, 128) state
LANES = 1 << LANE_QUBITS
MAX_HIGH = 3      # apply_kq widens over at most this many row qubits (D<=1024)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """A gate matrix as a tensor on ``ref``'s device, in its dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=ref.dtype,
                           device=ref.device)


def _cmul_contract(eq: str, ur, ui, re: torch.Tensor, im: torch.Tensor):
    """Complex (ur + i ui) contraction against (re + i im): four real
    einsums in IEEE fp32, as the JAX package's at precision="highest"."""
    ur, ui = _like(ur, re), _like(ui, re)
    with ieee_fp32():
        new_re = torch.einsum(eq, ur, re) - torch.einsum(eq, ui, im)
        new_im = torch.einsum(eq, ur, im) + torch.einsum(eq, ui, re)
    return new_re, new_im


def apply_1q(re, im, ur, ui, k: int, num_qubits: int):
    """Apply the 2x2 gate (ur + i ui) to qubit k of the flat (2^n,) pair."""
    n = num_qubits
    hi, lo = 1 << (n - k - 1), 1 << k
    nre, nim = _cmul_contract("ab,xbz->xaz", ur, ui, re.reshape(hi, 2, lo),
                              im.reshape(hi, 2, lo))
    return nre.reshape(-1), nim.reshape(-1)


def apply_2q(re, im, ur, ui, qa: int, qb: int, num_qubits: int):
    """Apply a 4x4 gate to the qubit pair; pair basis = bit(max)*2 +
    bit(min) (ir.gates' layout)."""
    n = num_qubits
    a, b = (qa, qb) if qa < qb else (qb, qa)
    shape = (1 << (n - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)
    ur4 = _like(ur, re).reshape(2, 2, 2, 2)   # [B_hi, B_lo, b_hi, b_lo]
    ui4 = _like(ui, re).reshape(2, 2, 2, 2)
    nre, nim = _cmul_contract("ABab,xaybz->xAyBz", ur4, ui4,
                              re.reshape(shape), im.reshape(shape))
    return nre.reshape(-1), nim.reshape(-1)


def apply_cnot(re, im, control: int, target: int, num_qubits: int):
    """Structural CNOT: the target axis flipped on the control = 1 half (an
    exact copy, no arithmetic)."""
    n = num_qubits
    c, t = control, target
    a, b = (c, t) if c < t else (t, c)
    shape = (1 << (n - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)
    c_axis, t_axis = (3, 1) if c < t else (1, 3)
    # after dropping c_axis, the target axis shifts down if it was above
    flip_axis = t_axis if t_axis < c_axis else t_axis - 1

    def one(x):
        v5 = x.reshape(shape)
        flipped = v5.select(c_axis, 1).flip(flip_axis)
        return torch.stack([v5.select(c_axis, 0), flipped],
                           dim=c_axis).reshape(-1)

    return one(re), one(im)


def apply_kq(re, im, ur, ui, qubits: Tuple[int, ...], num_qubits: int):
    """Apply a 2^k x 2^k fused block to k qubits (sorted ascending; matrix
    index = sum_j bit(qubits[j]) << j).

    Three arms, as in the JAX package: a contiguous run [a, a + k) is one
    reshape and einsum; a block with at most MAX_HIGH qubits >= 7 (n > 7)
    is ``_apply_kq_wide``; anything else transposes the (2,)*n view (torch
    permutes at most 25 dims, which the megakernel arm's n <= 8 keeps far
    from).
    """
    n = num_qubits
    k = len(qubits)
    if tuple(sorted(qubits)) != tuple(qubits):
        raise ValueError(f"qubits must be sorted, got {tuple(qubits)}")
    dim = 1 << k
    if tuple(ur.shape) != (dim, dim):
        raise ValueError(f"a {k}-qubit block needs a ({dim}, {dim}) matrix")

    a = qubits[0]
    if tuple(qubits) == tuple(range(a, a + k)):
        hi, lo = 1 << (n - a - k), 1 << a
        nre, nim = _cmul_contract("AB,xBz->xAz", ur, ui,
                                  re.reshape(hi, dim, lo),
                                  im.reshape(hi, dim, lo))
        return nre.reshape(-1), nim.reshape(-1)

    high = [q for q in qubits if q >= LANE_QUBITS]
    if n > LANE_QUBITS and len(high) <= MAX_HIGH:
        return _apply_kq_wide(re, im, ur, ui, qubits, n)

    axes_of_bit = [n - 1 - bit for bit in range(n)]
    tgt_axes = [axes_of_bit[q] for q in reversed(qubits)]  # block MSB first
    perm = tgt_axes + [ax for ax in range(n) if ax not in tgt_axes]
    inv = np.argsort(perm).tolist()

    def one(x):
        return x.reshape((2,) * n).permute(perm).reshape(dim, -1)

    def back(t):
        return t.reshape((2,) * n).permute(inv).reshape(-1)

    re_m, im_m = one(re), one(im)
    ur, ui = _like(ur, re), _like(ui, re)
    with ieee_fp32():
        nre = ur @ re_m - ui @ im_m
        nim = ur @ im_m + ui @ re_m
    return back(nre), back(nim)


def _apply_kq_wide(re, im, ur, ui, qubits, n):
    """A block as a row shuffle and one (R', D) @ (D, D)^T product.

    D = 2^(7 + kh): the matrix is expanded on the host over the 7 lane
    qubits plus the block's kh high qubits, and the state's row axes are
    permuted so those kh bits sit next to the lane dim (whole 128-wide
    rows move, never a bit inside a row)."""
    high = sorted(q for q in qubits if q >= LANE_QUBITS)
    kh = len(high)
    superset = tuple(range(LANE_QUBITS)) + tuple(high)
    u = _host(ur).astype(np.complex128) + 1j * _host(ui)
    big = expand_unitary(u, qubits, superset)
    bre = _like(np.ascontiguousarray(big.real.T, dtype=np.float32), re)
    bim = _like(np.ascontiguousarray(big.imag.T, dtype=np.float32), re)

    nrow = n - LANE_QUBITS
    # row axes: axis j <-> row bit nrow-1-j <-> qubit 7 + (nrow-1-j)
    axis_of_qubit = {LANE_QUBITS + b: nrow - 1 - b for b in range(nrow)}
    h_axes = [axis_of_qubit[q] for q in reversed(high)]  # D-index MSB first
    perm = [ax for ax in range(nrow) if ax not in h_axes] + h_axes
    inv = np.argsort(perm).tolist()
    D = (1 << kh) * LANES
    rows = (2,) * nrow + (LANES,)

    def fwd(x):
        return x.reshape(rows).permute(perm + [nrow]).reshape(-1, D)

    def bwd(t):
        return t.reshape(rows).permute(inv + [nrow]).reshape(-1)

    re_m, im_m = fwd(re), fwd(im)
    with ieee_fp32():
        # right-multiply: out[r, :] = big @ v[r, :]  ->  v @ big^T
        nre = re_m @ bre - im_m @ bim
        nim = im_m @ bre + re_m @ bim
    return bwd(nre), bwd(nim)
