"""The megakernel arm: a whole fused op list as one torch callable.

A port of the JAX package's ``engine/megakernel.py``, which traces the op
list into one jitted program (XLA is its megakernel; no Pallas kernel is
involved).  Here each op is the matching ``ops/apply.py`` primitive in
torch calls: a ``cx`` op is an exact copy, a 1- or 2-qubit op four real
einsums, a wider block ``apply_kq`` — IEEE fp32 throughout, or float64
for complex128 (the JAX package's ``real_dtype``; the matrices then stay
float64 from the host on).  The gate
matrices go to the device once, when the callable is built.

It runs every strategy's smallest widths (mxu, vmem and pallas at n <= 7,
prefetch at n < 9) and ``strategy="megakernel"`` at every width.
Callables are cached by the op list's fingerprint, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..ir.oplist import Op, ops_digest
from ..ops import apply as A

_CACHE: dict = {}
_CACHE_LIMIT = 64


def build_megakernel(ops: Sequence[Op], num_qubits: int, device="cuda",
                     dtype: torch.dtype = torch.float32) -> Callable:
    """A ``(re, im) -> (re, im)`` callable applying the whole op list to
    flat (2^n,) tensors of ``dtype`` (float32 or float64) on ``device``."""
    device = A.resolve_device(device)
    key = ops_digest(ops, f"{num_qubits}|{dtype}|{device}")
    fn = _CACHE.get(key)
    if fn is None:
        fn = _build(ops, num_qubits, device, dtype)
        if len(_CACHE) >= _CACHE_LIMIT:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = fn
    return fn


def _build(ops: Sequence[Op], n: int, device: torch.device,
           dtype: torch.dtype) -> Callable:
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def tab(x):
        return torch.as_tensor(np.asarray(x, dtype=np_dtype), device=device)

    baked = []
    for op in ops:
        if op.kind == "cx":
            baked.append(("cx", op.qubits, None, None))
        elif len(op.qubits) <= 2:
            baked.append(("u", op.qubits, tab(op.u.real), tab(op.u.imag)))
        else:
            # apply_kq's wide arm expands its matrix on the host
            baked.append(("u", op.qubits, np.asarray(op.u.real, np_dtype),
                          np.asarray(op.u.imag, np_dtype)))

    def kernel(re: torch.Tensor, im: torch.Tensor):
        for kind, qs, ur, ui in baked:
            if kind == "cx":
                re, im = A.apply_cnot(re, im, qs[0], qs[1], n)
            elif len(qs) == 1:
                re, im = A.apply_1q(re, im, ur, ui, qs[0], n)
            elif len(qs) == 2:
                re, im = A.apply_2q(re, im, ur, ui, qs[0], qs[1], n)
            else:
                re, im = A.apply_kq(re, im, ur, ui, qs, n)
        return re, im

    return kernel


def run_megakernel(ops: Sequence[Op], num_qubits: int, device, initial=None,
                   dtype: torch.dtype = torch.float32):
    """The arm as the engines run it: ``(re, im, len(ops), None)`` from
    |0...0> or the complex ``initial`` vector (the ops' basis)."""
    fn = build_megakernel(ops, num_qubits, device, dtype)
    if initial is None:
        re, im = A.initial_state_parts(num_qubits, dtype=dtype, device=device)
    else:
        re, im = A.split_state(initial, dtype=dtype, device=device)
    re, im = fn(re, im)
    return re, im, len(ops), None
