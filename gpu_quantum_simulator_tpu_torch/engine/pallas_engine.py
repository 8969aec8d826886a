"""The ``pallas`` strategy: fused blocks as 128 x 128 products over the
(R, 128) lane-layout state.

A port of the JAX package's ``engine/pallas_engine.py`` (the strategy
keeps its public name).  Pipeline, as there: fuse to <= 7-qubit blocks with
the Python passes (``fuse_k(fuse_4x4(circuit))``, not the native fuser),
then run the low-region planner (passes/shard.py ``plan_sharded`` with the
top n - 7 qubits as the "global" region): every block is rewritten onto
qubits 0..6 plus explicit low <-> high qubit swaps.  Each block expands to
a dense 128 x 128 unitary applied by the chain kernel with one matrix
(kernels/wide.py ``apply_block128``, TPU kernel 9), always in IEEE fp32 —
the JAX package hard-codes its precision there, whatever
``config.precision`` says.  Each swap is one torch transpose copy
(``swap_low_high``).  The state comes back in PHYSICAL positions;
``run_pallas`` returns the plan's ``final_position`` as the residual
layout.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ir.oplist import expand_unitary, op_matrix
from ..kernels.wide import apply_block128
from ..ops.apply import resolve_device
from ..passes.shard import ShardPlan, SwapItem

LANE_QUBITS = 7
LANES = 1 << LANE_QUBITS


def swap_low_high(re: torch.Tensor, im: torch.Tensor, low_bit: int,
                  qubit: int, n: int):
    """Swap low qubit ``low_bit`` (< 7) with ``qubit`` (>= 7): one
    transposed copy of each (hi, 2, mid, 2, lo) view."""
    a, b = low_bit, qubit
    shape = (1 << (n - b - 1), 2, 1 << (b - a - 1), 2, 1 << a)

    def one(x):
        return x.reshape(shape).transpose(1, 3).reshape(x.shape)

    return one(re), one(im)


class PallasProgram:
    """The plan's items with their device-resident 128 x 128 tables.

    Calling it maps a flat (2^n,) state pair through every item; the input
    pair is handed over (the block kernel writes into it)."""

    def __init__(self, plan: ShardPlan, num_qubits: int, device="cuda"):
        device = resolve_device(device)
        n = num_qubits
        self.num_qubits = n
        self._R = 1 << (n - LANE_QUBITS)
        low = tuple(range(LANE_QUBITS))
        self.items: List[tuple] = []
        for item in plan.items:
            if isinstance(item, SwapItem):
                self.items.append(("swap", item.pos_b, item.pos_a))
                continue
            u, qs = op_matrix(item)
            m = expand_unitary(u, qs, low)
            tab = np.stack([m.real, m.imag]).astype(np.float32)
            self.items.append(("mat", torch.from_numpy(tab).to(device)))
        self.num_mats = sum(it[0] == "mat" for it in self.items)
        self.num_swaps = len(self.items) - self.num_mats

    def __call__(self, re: torch.Tensor, im: torch.Tensor):
        n, R = self.num_qubits, self._R
        re, im = re.reshape(R, LANES), im.reshape(R, LANES)
        for item in self.items:
            if item[0] == "swap":
                re, im = swap_low_high(re, im, item[1], item[2], n)
            else:
                tab = item[1]
                re, im = apply_block128(re, im, tab[0], tab[1], out=(re, im))
        return re.reshape(-1), im.reshape(-1)


_CACHE: dict = {}
_CACHE_LIMIT = 8


def run_pallas(circuit, config, device, initial=None):
    """Simulator facade entry; returns (re, im, num_items, residual_perm).

    ``re``/``im`` are flat tensors on ``device`` in PHYSICAL positions:
    ``residual_perm[q]`` is where qubit q ended (None for the identity).
    ``initial``: optional complex start vector (the circuit's basis).
    Programs are cached by the circuit's gate stream (a repeat run skips
    fusion and planning)."""
    from ..ops.apply import initial_state_parts, split_state
    from ..passes.fuse4x4 import fuse_4x4
    from ..passes.fuse_k import fuse_k
    from ..passes.shard import plan_sharded
    from .prefetch import _circuit_fingerprint

    n = circuit.num_qubits
    device = resolve_device(device)
    if n <= LANE_QUBITS:
        # the state is one 128-wide row or less: the megakernel arm
        from .megakernel import run_megakernel

        ops = fuse_k(fuse_4x4(circuit),
                     max_qubits=min(config.max_fused_qubits, n))
        return run_megakernel(ops, n, device, initial)
    k = min(config.max_fused_qubits, LANE_QUBITS)
    key = (_circuit_fingerprint(circuit), n, k, str(device))
    cached = _CACHE.get(key)
    if cached is None:
        ops = fuse_k(fuse_4x4(circuit), max_qubits=k)
        plan = plan_sharded(ops, n, n - LANE_QUBITS)
        cached = (PallasProgram(plan, n, device), plan.final_position,
                  len(plan.items))
        if len(_CACHE) >= _CACHE_LIMIT:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = cached
    prog, perm, num_items = cached

    if initial is None:
        re, im = initial_state_parts(n, device=device)
    else:
        re, im = split_state(initial, device=device)
    re, im = prog(re, im)
    if np.array_equal(perm, np.arange(n)):
        perm = None
    return re, im, num_items, perm
