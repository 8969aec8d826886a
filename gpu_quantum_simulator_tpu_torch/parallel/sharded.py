"""Mesh-sharded state-vector engine on torch (the dense engine).

The port of the JAX package's ``parallel/sharded.py``.  Layout: the flat
2^n amplitude pair is cut into 2^d contiguous shards, one (re, im) pair a
mesh device (parallel/mesh.py), so the top d = log2(mesh) qubits are the
shard-index bits and the low n - d qubits are local.  A sharded state is
two lists, ``re[s]`` and ``im[s]`` the (2^(n-d),) tensors of shard s on
its device: nothing of size 2^n is ever put together on one device.

``ShardedProgram`` runs a ``passes.shard.plan_sharded`` item stream: local
fused ops are the single-device ``ops/apply.py`` primitives on every
shard; a swap of global position ``p`` with local position ``l`` is a
pairwise half-block exchange with the shard across shard-index bit
``p - (n - d)`` (``swap_halves``), the JAX package's ``lax.ppermute``; on
cards one launch a shard of csrc/gswap.cu pulls the partner's half over
the link (peer access, which a sharded state on cards requires).

Swap derivation (bit A = global p, bit B = local l, shard bit a, block half
b = bit l): amplitudes with b == a stay put (their new local bit equals the
old shard bit); amplitudes with b != a move to the partner shard and land
in its half l == 1 - partner_bit.  So each shard ships exactly half a block
— the minimum possible data motion for a qubit swap.  Each shard writes
its new block into a pair of its own: its kept half, and the partner's
shipped half.  Between two cards the second is a peer read (the kernel) or
a peer copy (torch), ordered after the current streams of both and before
their next work (an event each way), so the partner's last write is
complete before it is read and no later write of the partner overtakes it.

This engine serves complex128, shards of fewer than 9 qubits and
``shard_segmented=False``; the segmented engine
(parallel/sharded_prefetch.py) serves the rest.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..ops import apply as A
from ..passes.shard import LocalSwapItem, ShardPlan, SwapItem
from .mesh import Mesh, num_global_qubits

Shards = List[torch.Tensor]


def is_sharded(x) -> bool:
    """Whether ``x`` is one component of a sharded state (a list of
    per-shard tensors) rather than a flat tensor."""
    return isinstance(x, (list, tuple))


def shard_component(x, devices: Sequence[torch.device],
                    dtype=torch.float32) -> Shards:
    """One state component as new per-shard tensors on ``devices``: a flat
    numpy array or tensor of 2^n values, or a list of per-shard ones.  The
    caller's data is copied, never changed."""
    S = len(devices)
    if is_sharded(x):
        if len(x) != S:
            raise ValueError(f"a state of {len(x)} shards for a mesh of {S}")
        parts = list(x)
    else:
        size = x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size
        if size % S or (size // S) & (size // S - 1):
            raise ValueError(f"initial state has wrong length: {size} "
                             f"amplitudes over {S} shards")
        flat = x.reshape(-1) if isinstance(x, torch.Tensor) \
            else np.asarray(x).reshape(-1)
        step = size // S
        parts = [flat[s * step:(s + 1) * step] for s in range(S)]
    out = []
    for p, dev in zip(parts, devices):
        if isinstance(p, torch.Tensor):
            out.append(p.to(device=dev, dtype=dtype, copy=True).reshape(-1))
        else:
            out.append(torch.tensor(np.asarray(p), dtype=dtype,
                                    device=dev).reshape(-1))
    sizes = {t.numel() for t in out}
    if len(sizes) != 1:
        raise ValueError(f"shards of unequal sizes {sorted(sizes)}")
    return out


def initial_shards(num_qubits: int, devices: Sequence[torch.device],
                   dtype=torch.float32) -> Tuple[Shards, Shards]:
    """|0...0> as per-shard (re, im) tensors."""
    S = len(devices)
    size = (1 << num_qubits) // S
    re = [torch.zeros(size, dtype=dtype, device=dev) for dev in devices]
    im = [torch.zeros(size, dtype=dtype, device=dev) for dev in devices]
    re[0][:1].fill_(1.0)
    return re, im


def swap_halves(re: Shards, im: Shards, g: int, l: int,
                out: Optional[List[Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]]]] = None):
    """Exchange shard-index bit ``g`` with local bit ``l`` of a sharded
    state; returns the new (re, im) shard lists.

    Shard s (its bit g = my) keeps its half l == my and receives its
    partner's (s ^ 2^g) half l == my into its half l == 1 - my.  Each shard
    writes into ``out[s]`` (a pair shaped like its shard; allocated when
    None); the input shards are only read.  Float32 shards on cards, with
    l >= 2, take one launch a shard of csrc/gswap.cu (``gswap_halves``);
    the rest (the CPU, float64, l < 2) two torch copies a component
    (``gswap_halves_plain``).  Shards on distinct cards need peer access
    between them: where it cannot be enabled, this raises rather than let
    a copy go through the host.

    Timed as the ``qsim/gswap`` span; counted in ``gswap_peer_bytes`` (the
    partners' halves shipped between distinct devices) and
    ``gswap_local_bytes`` (the kept halves, and partners' halves on the
    same device).
    """
    S = len(re)
    half = re[0].numel() // 2 * re[0].element_size() * 2   # both components
    peer = sum(re[s].device != re[s ^ (1 << g)].device for s in range(S))
    telemetry.count("gswap_peer_bytes", peer * half)
    telemetry.count("gswap_local_bytes", (2 * S - peer) * half)
    with telemetry.span("qsim/gswap"):
        pairs = [out[s] if out is not None and out[s] is not None else (
            torch.empty_like(re[s]), torch.empty_like(im[s]))
            for s in range(S)]
        if _on_cards(re) and l >= 2 and re[0].dtype == torch.float32:
            gswap_halves(re, im, g, l, pairs)
        else:
            gswap_halves_plain(re, im, g, l, pairs)
    return [p[0] for p in pairs], [p[1] for p in pairs]


_PEERS: set = set()        # (device, peer) pairs with peer access enabled


def _on_cards(re: Shards) -> bool:
    """Whether the shards sit on cards; enables peer access between every
    two distinct cards among them the first time (csrc/gswap.cu
    ``qsim_enable_peer``), and raises, naming the pair and the CUDA error,
    where it cannot be enabled."""
    if not re[0].is_cuda:
        return False
    devs = sorted({t.device.index for t in re})
    for a in devs:
        for b in devs:
            if a == b or (a, b) in _PEERS:
                continue
            from ..kernels import build

            lib = build.load()
            rc = lib.qsim_enable_peer(a, b)
            if rc != 0:
                raise RuntimeError(
                    f"peer access from cuda:{a} to cuda:{b}: CUDA error "
                    f"{rc} ({lib.qsim_error_string(rc).decode()}); a "
                    "sharded state needs its cards to read each other's "
                    "memory")
            _PEERS.add((a, b))
    return True


def gswap_halves_plain(re: Shards, im: Shards, g: int, l: int,
                       pairs) -> None:
    """``swap_halves`` by torch view copies into ``pairs``, two a
    component a shard (torch orders a copy between cards after the current
    streams of both, an event each way)."""
    nl = re[0].numel().bit_length() - 1
    hi, lo = 1 << (nl - l - 1), 1 << l
    for s in range(len(re)):
        my = (s >> g) & 1
        p = s ^ (1 << g)
        for src, part, dst in ((re[s], re[p], pairs[s][0]),
                               (im[s], im[p], pairs[s][1])):
            v = dst.view(hi, 2, lo)
            v[:, my].copy_(src.view(hi, 2, lo)[:, my])
            v[:, 1 - my].copy_(part.view(hi, 2, lo)[:, my])


@telemetry.counted
def gswap_halves(re: Shards, im: Shards, g: int, l: int, pairs) -> None:
    """``swap_halves`` on cards (float32, l >= 2, peer access on): shard
    s's launch of csrc/gswap.cu, on its own card's current stream, reads
    its kept half and its partner's half and writes ``pairs[s]``.  That
    stream first waits for the partner's stream (the partner's last write
    of its shard is done before it is read), and the partner's stream then
    waits for the launch (the partner overwrites its shard, which becomes
    its spare, only once it has been read).  ``gswap_halves.launches``
    counts the launches, one a shard."""
    from ..kernels import build

    lib = build.load()
    S = len(re)
    streams = [torch.cuda.current_stream(t.device) for t in re]
    ready = [torch.cuda.Event() for _ in range(S)]
    for ev, st in zip(ready, streams):
        ev.record(st)
    done = [torch.cuda.Event() for _ in range(S)]
    for s in range(S):
        p = s ^ (1 << g)
        streams[s].wait_event(ready[p])
        with torch.cuda.device(re[s].device):
            build.check(lib, lib.qsim_gswap_halves(
                re[s].data_ptr(), im[s].data_ptr(), re[p].data_ptr(),
                im[p].data_ptr(), pairs[s][0].data_ptr(),
                pairs[s][1].data_ptr(), re[s].numel(), l, (s >> g) & 1,
                streams[s].cuda_stream), "gswap")
        gswap_halves.launches += 1
        done[s].record(streams[s])
    for s in range(S):
        streams[s ^ (1 << g)].wait_event(done[s])


gswap_halves.launches = 0


def local_swap(re: Shards, im: Shards, a: int, b: int):
    """Exchange two LOCAL bit positions in every shard (no exchange between
    shards): one transposed copy of each component."""
    if a > b:
        a, b = b, a
    nl = re[0].numel().bit_length() - 1
    out = [A._swap_bits_device(r, i, a, b, nl) for r, i in zip(re, im)]
    return [o[0] for o in out], [o[1] for o in out]


def unpermute_sharded(re: Shards, im: Shards, perm,
                      devices: Sequence[torch.device]):
    """Undo a qubit relabeling on a sharded state without a join (the JAX
    package's on-device transpose of a sharded array; ``perm`` as in
    ``ops/apply.py`` ``unpermute_device``).

    The permutation decomposes into bit transpositions: two local bits are
    a transpose in every shard, a local and a shard bit a half-block
    exchange, two shard bits a reordering of the shards (moved to their
    mesh device where it differs)."""
    n = len(perm)
    nl = n - (len(re).bit_length() - 1)
    for a, b in A.bit_transpositions(perm):
        if b < nl:
            re, im = local_swap(re, im, a, b)
        elif a < nl:
            re, im = swap_halves(re, im, b - nl, a)
        else:
            ga, gb = a - nl, b - nl

            def swapped(s):
                ba, bb = (s >> ga) & 1, (s >> gb) & 1
                return s & ~((1 << ga) | (1 << gb)) | (bb << ga) | (ba << gb)

            order = [swapped(s) for s in range(len(re))]
            re = [re[t].to(devices[s]) for s, t in enumerate(order)]
            im = [im[t].to(devices[s]) for s, t in enumerate(order)]
    return re, im


def join_shards(re: Shards, im: Shards) -> np.ndarray:
    """A sharded state as one complex host vector: each shard is copied
    into its own slice of a page-locked host buffer (no device holds the
    whole state)."""
    size = sum(t.numel() for t in re)
    dt = re[0].dtype
    cuda = any(t.is_cuda for t in re)
    with telemetry.span("qsim/d2h") if cuda else contextlib.nullcontext():
        host_re = torch.empty(size, dtype=dt, pin_memory=cuda)
        host_im = torch.empty(size, dtype=dt, pin_memory=cuda)
        off = 0
        for r, i in zip(re, im):
            k = r.numel()
            host_re[off:off + k].copy_(r, non_blocking=cuda)
            host_im[off:off + k].copy_(i, non_blocking=cuda)
            if r.is_cuda:
                telemetry.count("state_d2h_bytes",
                                2 * k * r.element_size())
            off += k
        if cuda:
            for dev in {t.device for t in re if t.is_cuda}:
                torch.cuda.synchronize(dev)
    return A.join_state(host_re, host_im)


def synchronize(re: Shards) -> None:
    """Wait for every card that holds a shard."""
    for dev in {t.device for t in re if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _baked_items(plan: ShardPlan, local_n: int, real_dtype):
    """The plan's items with their matrices as host arrays of the state's
    dtype (the JAX package bakes them in as constants)."""
    dt = np.float64 if real_dtype == torch.float64 else np.float32
    baked = []
    for item in plan.items:
        if isinstance(item, SwapItem):
            baked.append(("swap", item.pos_a - local_n, item.pos_b, None, None))
        elif isinstance(item, LocalSwapItem):
            baked.append(("lswap", item.pos_a, item.pos_b, None, None))
        elif item.kind == "cx":
            baked.append(("cx", item.qubits[0], item.qubits[1], None, None))
        else:
            baked.append(("u", item.qubits, None,
                          np.asarray(item.u.real, dtype=dt),
                          np.asarray(item.u.imag, dtype=dt)))
    return baked


class ShardedProgram:
    """A planned circuit bound to a mesh: callable on a sharded (re, im)
    state (or a flat pair, split into new shards), returning new shard
    lists; the inputs are not changed.

    Used by ``run_sharded`` (one-shot) and ``run_device_iterated`` (the body
    is planned layout-closed via ``restore_layout`` so repetitions compose).
    """

    def __init__(self, circuit, config, mesh: Mesh,
                 restore_layout: bool = False):
        from ..passes.fuse4x4 import fuse_4x4
        from ..passes.fuse_k import fuse_k
        from ..passes.shard import plan_sharded

        n = circuit.num_qubits
        axis = config.mesh_axis_names[0]
        d = num_global_qubits(mesh, axis)
        if d >= n:
            raise ValueError(f"{n}-qubit state cannot shard over 2^{d} devices")
        local_n = n - d

        k = min(config.max_fused_qubits, local_n, n)
        # two-level planning: cap fused blocks at 2 logical qubits above the
        # lane region AND have the planner relocate crowded shard-high
        # positions (LocalSwapItem), as in the JAX package
        max_high = 2 if local_n > 7 else None
        ops = fuse_k(fuse_4x4(circuit), max_qubits=k, max_high=max_high)
        plan = plan_sharded(
            ops, n, d,
            max_local_high=2 if local_n > 7 else None,
            restore_layout=restore_layout,
        )
        self.num_qubits = n
        self.mesh = mesh
        self.devices = mesh.device_list
        self.plan = plan
        self.real_dtype = (torch.float32 if config.dtype == "complex64"
                           else torch.float64)
        self._local_n = local_n
        self._items = _baked_items(plan, local_n, self.real_dtype)

    def init_state(self, initial_parts=None):
        if initial_parts is None:
            return initial_shards(self.num_qubits, self.devices,
                                  self.real_dtype)
        return tuple(shard_component(x, self.devices, self.real_dtype)
                     for x in initial_parts)

    def __call__(self, re, im):
        if not is_sharded(re):
            re, im = self.init_state((re, im))
        re, im = list(re), list(im)
        nl = self._local_n
        for kind, a, b, ur, ui in self._items:
            if kind == "swap":
                re, im = swap_halves(re, im, a, b)
            elif kind == "lswap":
                re, im = local_swap(re, im, a, b)
            else:
                for s in range(len(re)):
                    if kind == "cx":
                        re[s], im[s] = A.apply_cnot(re[s], im[s], a, b, nl)
                    elif len(a) == 1:
                        re[s], im[s] = A.apply_1q(re[s], im[s], ur, ui, a[0],
                                                  nl)
                    elif len(a) == 2:
                        re[s], im[s] = A.apply_2q(re[s], im[s], ur, ui, a[0],
                                                  a[1], nl)
                    else:
                        re[s], im[s] = A.apply_kq(re[s], im[s], ur, ui, a, nl)
        return re, im

    @property
    def residual(self):
        perm = self.plan.final_position
        if np.array_equal(perm, np.arange(self.num_qubits)):
            return None
        return perm


def run_sharded(circuit, config, mesh: Mesh, initial_parts=None):
    """Entry used by the Simulator facade; returns (re, im, num_ops, perm)
    with ``re``/``im`` shard lists."""
    prog = ShardedProgram(circuit, config, mesh)
    re, im = prog.init_state(initial_parts)
    re, im = prog(re, im)
    # The plan's swaps leave a layout permutation; the Simulator undoes it
    # on the shards (unpermute_sharded).
    return re, im, len(prog.plan.items), prog.residual
