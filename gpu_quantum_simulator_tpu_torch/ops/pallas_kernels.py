"""The lane-layout kernels, on torch: the counterpart of the JAX package's
``ops/pallas_kernels.py``.

Layout: the 2^n amplitude pair is a float32 (R, 128) matrix pair with
R = 2^(n-7): the low 7 qubits are the lane (column) index, the high n-7
qubits the row index.

* ``apply_block128`` (TPU kernel 9): ``S @ M^T`` for one 128 x 128 complex
  matrix, the chain kernel with one matrix (kernels/wide.py,
  csrc/wide_chain.cu).

Both ops take the JAX signatures: the state as ``s_re``/``s_im``, and the
keyword-only ``tile_rows=`` (``apply_block128``) and ``interpret=``,
checked as the JAX package checks them and then ignored (the TPU's VMEM
tile and Pallas's interpreter have no counterpart on the card).
* ``apply_butterfly_high`` (TPU kernel 10): a 2 x 2 gate on one high qubit,
  csrc/butterfly_high.cu, one read and one write of the state.  No engine
  calls it, as in the JAX package: it is a public op.
* ``swap_low_high``: a low qubit exchanged with a high one, one torch
  transposed copy (the JAX package's XLA transpose).

``apply_butterfly_high`` launches its CUDA kernel for a CUDA state and runs
``apply_butterfly_high_plain`` — the same function in plain torch — for a
CPU state; any other device raises.  ``apply_butterfly_high.launches``
counts its kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..kernels import build
from ..kernels.wide import apply_block128, check_tpu_keywords

LANE_QUBITS = 7
LANES = 1 << LANE_QUBITS

Pair = Tuple[torch.Tensor, torch.Tensor]

__all__ = ["apply_block128", "apply_butterfly_high",
           "apply_butterfly_high_plain", "swap_low_high"]


def swap_low_high(re: torch.Tensor, im: torch.Tensor, low_bit: int,
                  qubit: int, n: int):
    """Swap low qubit ``low_bit`` (< 7) with ``qubit`` (>= 7): one
    transposed copy of each (hi, 2, mid, 2, lo) view."""
    a, b = low_bit, qubit
    shape = (1 << (n - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)

    def one(x):
        return x.reshape(shape).transpose(1, 3).reshape(x.shape)

    return one(re), one(im)


def gate_table(u) -> np.ndarray:
    """The 2 x 2 complex gate as eight float32 values [u00r, u00i, u01r,
    u01i, u10r, u10i, u11r, u11i] (the JAX kernel's (2, 4) SMEM table)."""
    u = np.asarray(u.cpu() if isinstance(u, torch.Tensor) else u)
    if u.shape != (2, 2):
        raise ValueError(f"butterfly: the gate is 2 x 2, got {u.shape}")
    return np.array([u[0, 0].real, u[0, 0].imag, u[0, 1].real, u[0, 1].imag,
                     u[1, 0].real, u[1, 0].imag, u[1, 1].real, u[1, 1].imag],
                    dtype=np.float32)


def _check_state(re: torch.Tensor, im: torch.Tensor, high_bit: int) -> int:
    rows = re.shape[0] if re.dim() == 2 else 0
    if re.dim() != 2 or re.shape != (rows, LANES) or im.shape != re.shape:
        raise ValueError(f"butterfly: state must be (R, {LANES}), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if rows & (rows - 1) or not 0 <= high_bit < rows.bit_length() - 1:
        raise ValueError(f"butterfly: high_bit {high_bit} needs a power-of-"
                         f"two R > 2^high_bit, got R = {rows}")
    return rows


def apply_butterfly_high_plain(re: torch.Tensor, im: torch.Tensor, u,
                               high_bit: int) -> Pair:
    """The gate on row bit ``high_bit`` in plain torch on a (G, 2, S, 128)
    view, S = 2^high_bit, with the JAX kernel's float32 coefficients and
    sums; new tensors, any device."""
    rows = _check_state(re, im, high_bit)
    c = [float(x) for x in gate_table(u)]
    s = 1 << high_bit
    vr = re.reshape(rows // (2 * s), 2, s, LANES)
    vi = im.reshape(rows // (2 * s), 2, s, LANES)
    ar, br, ai, bi = vr[:, 0], vr[:, 1], vi[:, 0], vi[:, 1]

    def mix(xr, xi, yr, yi):
        return (xr * ar - xi * ai + yr * br - yi * bi,
                xr * ai + xi * ar + yr * bi + yi * br)

    oar, oai = mix(*c[:4])
    obr, obi = mix(*c[4:])
    return (torch.stack([oar, obr], dim=1).reshape(rows, LANES),
            torch.stack([oai, obi], dim=1).reshape(rows, LANES))


@telemetry.counted
def apply_butterfly_high(s_re: torch.Tensor, s_im: torch.Tensor, u,
                         high_bit: int, *, interpret: bool = False,
                         out: Optional[Pair] = None) -> Pair:
    """Apply the 2 x 2 complex gate ``u`` on row bit ``high_bit`` (qubit
    ``high_bit + 7``) of the (R, 128) float32 pair, with the JAX op's
    signature.

    ``interpret`` is checked and otherwise ignored: it picks Pallas's
    interpreter on the TPU side, and here a CPU state runs the plain
    version while a CUDA state runs the kernel.  The result lands in
    ``out`` (allocated when None; it may be the input pair, since the
    kernel owns both rows of every pair)."""
    re, im = s_re, s_im
    check_tpu_keywords(interpret)
    if re.device.type == "cpu":
        res = apply_butterfly_high_plain(re, im, u, high_bit)
        if out is None:
            return res
        out[0].copy_(res[0])
        out[1].copy_(res[1])
        return out
    if not re.is_cuda:
        raise ValueError(f"butterfly kernel: unsupported device {re.device}")
    rows = _check_state(re, im, high_bit)
    table = gate_table(u)
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    for t in (re, im, *out):
        if t.device != re.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != re.shape:
            raise ValueError(
                "butterfly kernel: state and out must be contiguous float32 "
                f"({rows}, {LANES}) tensors on {re.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = build.load()
    rc = lib.qsim_butterfly_high(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        rows, high_bit, table.ctypes.data,
        torch.cuda.current_stream(re.device).cuda_stream)
    build.check(lib, rc, "butterfly kernel")
    apply_butterfly_high.launches += 1
    return out


def reset_launches() -> None:
    """Set the launch count of ``apply_butterfly_high`` to 0."""
    apply_butterfly_high.launches = 0


reset_launches()
