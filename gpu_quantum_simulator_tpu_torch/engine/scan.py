"""Scan engine: execution from dense, padded gate tables.

The port of the JAX package's ``engine/scan.py``.  The reference's
constant-memory design separates the (fixed) kernel from the (variable)
gate tables uploaded via cudaMemcpyToSymbol
(quantum_simulator_preproces_constant.cu:448-451).  The JAX package runs
one ``lax.scan`` over the tables, compiled per (num_qubits, padded-op-count
bucket); here the tables go to the device once a run (page-locked, no
wait) and each row is applied as torch ops.  No hand kernel is involved,
as no Pallas kernel is in the JAX package.

Every table row is a CONTROLLED 1q gate, which uniformly encodes:
  * a plain 1q gate U on target t:         cmask=0,     tmask=1<<t
  * cx(c, t) (U = X):                      cmask=1<<c,  tmask=1<<t
  * identity padding:                      cmask=0,     tmask=0, U=I

A row is branch-free on the device: partner amplitudes are gathered at
``i XOR tmask`` (the reference's bit-insertion pair indexing,
quantum_simulator_naive.cu:79-80, as an XOR gather), ``where`` on the
target bit picks each element's matrix row, and the control mask selects
where the row acts.  The padding rows run too, as in the JAX package: the
bucket is part of what the ablation measures.  The host reads each row's
masks from the numpy tables it built; nothing is read back from the device.

Memory: torch gathers with int64 indices, so the basis index ``arange(2^n)``
(built once per (n, device)) and each row's partner index take 8·2^n bytes
each, against 4·2^n for the JAX package's int32 index below n = 31; a row's
other temporaries (two gathered parts, four selected coefficients, two new
parts and two masks) come on top.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ir.oplist import Op
from ..ops import apply as A


class GateTables(NamedTuple):
    """Dense SoA gate tables on the host (the analog of
    d_Ur/d_Ui/d_Targ/d_Arg, quantum_simulator_preproces_constant.cu:58-61)."""

    ur: np.ndarray     # (ops, 2, 2) float
    ui: np.ndarray     # (ops, 2, 2) float
    tmask: np.ndarray  # (ops,) int32/int64: 1 << target (0 = padding)
    cmask: np.ndarray  # (ops,) int32/int64: 1 << control (0 = uncontrolled)


_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_I = np.eye(2)


def build_tables(
    ops: Sequence[Op],
    pad_to: int,
    real_dtype=np.float32,
    index_dtype=np.int32,
) -> GateTables:
    """Pack a (1q + cx) op list into padded tables.

    Wider fused ops are not representable here; run fuse_2x2 first (the scan
    engine is the "preproces + constant tables" ablation, not the 4x4 one).
    """
    m = len(ops)
    if pad_to < m:
        raise ValueError("pad_to smaller than op count")
    ur = np.tile(_I, (pad_to, 1, 1)).astype(real_dtype)
    ui = np.zeros((pad_to, 2, 2), dtype=real_dtype)
    tmask = np.zeros(pad_to, dtype=index_dtype)
    cmask = np.zeros(pad_to, dtype=index_dtype)
    for j, op in enumerate(ops):
        if op.kind == "cx":
            c, t = op.qubits
            ur[j] = _X
            tmask[j] = 1 << t
            cmask[j] = 1 << c
        elif op.width == 1:
            ur[j] = op.u.real
            ui[j] = op.u.imag
            tmask[j] = 1 << op.qubits[0]
        else:
            raise ValueError(
                f"scan engine takes 1q/cx ops only, got width {op.width}"
            )
    return GateTables(ur, ui, tmask, cmask)


def bucket_size(num_ops: int, bucket: int) -> int:
    return max(bucket, -(-num_ops // bucket) * bucket)


_INDEX: dict = {}


def _basis_index(num_qubits: int, device: torch.device) -> torch.Tensor:
    """``arange(2^n)`` as int64 on ``device``, built once per (n, device)
    (one entry: a new width or device replaces it)."""
    key = (num_qubits, str(device))
    idx = _INDEX.get(key)
    if idx is None:
        _INDEX.clear()
        idx = _INDEX[key] = torch.arange(1 << num_qubits, dtype=torch.int64,
                                         device=device)
    return idx


def run_tables(re: torch.Tensor, im: torch.Tensor, tables: GateTables,
               num_qubits: int):
    """Apply every row of the tables, padding included, to the flat pair."""
    idx = _basis_index(num_qubits, re.device)
    coef = A.upload(np.stack([tables.ur, tables.ui]),
                    re.device)   # (2, rows, 2, 2): one pinned copy
    for j in range(len(tables.tmask)):
        tmask = int(tables.tmask[j])
        cmask = int(tables.cmask[j])
        ur, ui = coef[0, j], coef[1, j]
        partner = idx ^ tmask
        pre = torch.take(re, partner)
        pim = torch.take(im, partner)
        tbit = (idx & tmask) != 0
        # per-element matrix entries: row tbit of U acting on (self, partner)
        a_r = torch.where(tbit, ur[1, 1], ur[0, 0])
        a_i = torch.where(tbit, ui[1, 1], ui[0, 0])
        b_r = torch.where(tbit, ur[1, 0], ur[0, 1])
        b_i = torch.where(tbit, ui[1, 0], ui[0, 1])
        new_re = a_r * re - a_i * im + b_r * pre - b_i * pim
        new_im = a_r * im + a_i * re + b_r * pim + b_i * pre
        active = (idx & cmask) == cmask  # cmask == 0 -> everywhere
        re = torch.where(active, new_re, re)
        im = torch.where(active, new_im, im)
    return re, im


def run_scan(ops: Sequence[Op], num_qubits: int, re: torch.Tensor,
             im: torch.Tensor, bucket: int = 256):
    tables = build_tables(
        ops,
        bucket_size(len(ops), bucket),
        real_dtype=np.float64 if re.dtype == torch.float64 else np.float32,
        index_dtype=np.int64 if num_qubits >= 31 else np.int32,
    )
    return run_tables(re, im, tables, num_qubits)
