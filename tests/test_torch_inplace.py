"""The port's in-place split-state prefetch engine against the JAX package.

The state is four (R2, 128) column halves and every entry runs inside them.
With shrunken tiles (4-row tiles, 1-row relayout blocks) n = 11-12 plans
real cross-tile swaps and relayouts.  Held to the JAX package, whose Pallas
kernels run in interpret mode: the packed entries of both arms (prologues
hoisted into pair-swap entries; ``fold_xswap``, the JAX package's
``_STREAM_PLAIN``, keeping them on their blocks), each kernel's plain torch
version on the same scal rows and tables (``get_split_kernels``,
``get_stream_split_kernel``, ``get_inplace_relayout_kernel``), one set of
JAX-packed tables through both chains, and the Simulator end to end.  On a
CPU tensor every wrapper is its plain version; the CUDA kernels are held to
these on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.engine.simulator import _fuse_pipeline as j_fuse
from gpu_quantum_simulator_tpu.ref.cpu import simulate_reference

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import telemetry
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline as t_fuse
from gpu_quantum_simulator_tpu_torch.kernels import relayout as KR
from gpu_quantum_simulator_tpu_torch.kernels import split as KS
from gpu_quantum_simulator_tpu_torch.ops.apply import initial_state_parts

N = 11
TILE = 4
TOL = 1e-6           # "highest": f32 products in another order, |amp| ~ 0.02
HIGH_TOL = 4e-6      # the JAX "high" rung's budget (tests/test_precision_auto.py)
SIM_TOL = 2e-5       # tests/test_prefetch.py TOL, Simulator against f64
F32 = np.float32


def _clear():
    for cache in (JPF._KERNEL_CACHE, JPF._CHAIN_CACHE, JPF._PROGRAM_CACHE,
                  JPF._RUN_CACHE, TPF._PROGRAM_CACHE, TPF._RUN_CACHE):
        cache.clear()


@pytest.fixture
def tiles(monkeypatch):
    """Set (TILE_ROWS, RELAYOUT_TILE_ROWS) in both packages, caches cleared."""
    def set_tiles(t, tr):
        for pf in (JPF, TPF):
            monkeypatch.setattr(pf, "TILE_ROWS", t)
            monkeypatch.setattr(pf, "RELAYOUT_TILE_ROWS", tr)
        _clear()

    yield set_tiles
    _clear()


def _unitary(rng, d):
    q, r = np.linalg.qr(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _monomial(rng, d):
    u = np.zeros((d, d), dtype=complex)
    u[np.arange(d), rng.permutation(d)] = np.exp(
        1j * rng.uniform(-np.pi, np.pi, d))
    return u


def _state(rng, n):
    """A normalized random state as four numpy halves."""
    R2 = 1 << (n - TPF.LOCAL_QUBITS)
    v = rng.standard_normal((2, R2, TPF.DVIEW))
    v = (v / np.linalg.norm(v)).astype(F32)
    return [np.ascontiguousarray(h) for h in
            (v[0][:, :128], v[0][:, 128:], v[1][:, :128], v[1][:, 128:])]


def _tensors(halves):
    return tuple(torch.from_numpy(h.copy()) for h in halves)


def _max_diff(got, want):
    return max(float(np.max(np.abs(g.numpy() - np.asarray(w))))
               for g, w in zip(got, want))


# ------------------------------------------------------------ the entries
def _jax_host_parts(ops, n, **kw):
    prog = JPF.PrefetchProgram(ops, n, interpret=True, inplace=True, **kw)
    return prog, [(part[3], list(part[4:12])) for part in prog._host_parts]


@pytest.mark.parametrize("fold", [False, True], ids=["hoisted", "fold_xswap"])
@pytest.mark.parametrize("n,portfolio", [(12, False), (12, True), (11, False)])
def test_inplace_entries_equal_jax(tiles, monkeypatch, n, portfolio, fold):
    """Every packed array of the in-place program equals the JAX package's,
    with the prologues hoisted (scal mode 2) and folded (mode 1)."""
    tiles(TILE, 1)
    monkeypatch.setattr(JPF, "_STREAM_PLAIN", fold)
    if portfolio:
        for pf in (JPF, TPF):
            monkeypatch.setattr(pf, "PORTFOLIO_MIN_QUBITS", n)
    jops = j_fuse(JM.grover_like(n, 300, 13), 7, max_high=2)
    tops = t_fuse(T.models.grover_like(n, 300, 13), 7, max_high=2)
    _, want = _jax_host_parts(jops, n)
    prog = TPF.PrefetchProgram(tops, n, device="cpu", inplace=True,
                               fold_xswap=fold)
    got = prog._chain._parts
    assert len(got) == len(want)
    for (gscal, gtabs), (wscal, wtabs) in zip(got, want):
        assert np.array_equal(np.asarray(gscal, dtype=np.int32), wscal)
        for g, w in zip(gtabs, wtabs):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    modes = prog.mode_rows
    assert (modes.get(3, 0) > 0) == (n == 12) and 5 not in modes
    assert (modes.get(1, 0) > 0 and 2 not in modes) if fold else \
        (modes.get(2, 0) > 0 and 1 not in modes)


def test_hoisted_entries_keep_every_step(tiles):
    tiles(TILE, 1)
    ops = t_fuse(T.models.grover_like(12, 300, 13), 7, max_high=2)
    plan = TPF.plan_prefetch(ops, 12, involution_relayout=True)
    out = TPF.hoist_prologues(plan.blocks)
    pro = sum(b.prologue is not None for b in plan.blocks)
    assert pro > 0 and len(out) == len(plan.blocks) + pro
    assert [k for b in out for k in b.kinds] == \
        [k for b in plan.blocks for k in b.kinds]
    assert all(not b.kinds for b in out if b.prologue is not None)


# -------------------------------------------------- kernel 4: the relayout
def _oracle_relayout(state, n, sigma):
    m = len(sigma)
    perm = list(range(n))
    for a in range(m):
        perm[8 + a] = 8 + int(sigma[a])
    idx = np.arange(1 << n)
    src = np.zeros(1 << n, dtype=np.int64)
    for b in range(n):
        src |= ((idx >> perm[b]) & 1) << b
    return state[src]


@pytest.mark.parametrize("sigma", [[2, 1, 0], [1, 0, 2], [0, 2, 1],
                                   [0, 1, 2]], ids=str)
def test_inplace_relayout_plain_matches_jax_and_oracle(tiles, sigma):
    """Bit-exact against get_inplace_relayout_kernel and a numpy
    bit-shuffle; fixed blocks stay, the rest swap in pairs."""
    tiles(TILE, 1)
    halves = _state(np.random.default_rng(1), N)
    scal = np.zeros(4 + 2 * JPF.CAP_STEPS, dtype=np.int32)
    scal[1] = 3
    scal[4 : 4 + len(sigma)] = sigma
    want = JPF.get_inplace_relayout_kernel(N, F32, True)(
        jnp.asarray(scal), *(jnp.asarray(h) for h in halves))
    got = KR.run_relayout_inplace_plain(sigma, _tensors(halves), 1)
    assert _max_diff(got, want) == 0.0
    routed = KR.run_relayout_inplace(sigma, _tensors(halves), 1)
    assert all(torch.equal(a, b) for a, b in zip(routed, got))
    for c in (0, 2):                       # re, then im, against the oracle
        flat = np.concatenate([halves[c], halves[c + 1]], axis=1).reshape(-1)
        joined = torch.cat([got[c], got[c + 1]], dim=1).reshape(-1).numpy()
        assert np.array_equal(joined, _oracle_relayout(flat, N, sigma))


def test_inplace_relayout_refuses_a_non_involution(tiles):
    tiles(TILE, 1)
    halves = _tensors(_state(np.random.default_rng(2), N))
    with pytest.raises(ValueError, match="involution"):
        KR.run_relayout_inplace([1, 2, 0], halves, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        KR.run_relayout_inplace([2, 1, 0], tuple(
            torch.empty(h.shape, device="meta") for h in halves), 1)


# ------------------------------------------- kernels 5 and 6: the blocks
BLOCK_NAMES = ("full", "mat-first", "mono-first", "perm-first",
               "tswap-first", "swap-only", "index-only")
EXACT = {"perm-first", "tswap-first", "swap-only", "index-only"}


def _blocks(rng, logt):
    """One block of every step kind, pair-mode blocks whose first step is a
    mat, a mono, a perm or a tswap, the swap alone, and index steps only."""
    def mat(width, mono=False, operm=None):
        d = 1 << width
        u = _monomial(rng, d) if mono else _unitary(rng, d)
        pos = tuple(int(p) for p in rng.permutation(TPF.LOCAL_QUBITS)[:width])
        return (u, pos, operm)

    perm, mono = logt + 1, logt + 2
    full = TPF._Block()
    steps = ([(0, mat(7)), (mono, mat(5, mono=True))]
             + [(perm, v) for v in range(TPF.LANE_QUBITS)]
             + [(k, 0) for k in range(1, logt + 1)]
             + [(0, mat(3, operm=TPF._window_swap_index(2))),
                (mono, mat(7, mono=True))])
    for kind, arg in steps:
        full.kinds.append(kind)
        if kind in (0, mono):
            full.midx.append(len(full.mats))
            full.mats.append(arg)
        else:
            full.midx.append(arg)
    pro = (1, 0)
    return [
        full,
        TPF._Block(kinds=[0, 0], midx=[0, 1], mats=[mat(6), mat(2)],
                   prologue=pro),
        TPF._Block(kinds=[mono, 0], midx=[0, 1],
                   mats=[mat(4, mono=True), mat(2)], prologue=pro),
        TPF._Block(kinds=[perm, 1], midx=[3, 0], prologue=pro),
        TPF._Block(kinds=[logt, perm], midx=[0, 5], prologue=pro),
        TPF._Block(prologue=pro),
        TPF._Block(kinds=[1, perm, logt, perm], midx=[0, 0, 0, 6]),
    ]


@pytest.fixture(scope="module")
def case():
    """Shrunken tiles in both packages; the blocks packed as in-place
    entries with the swap folded (mode 1), tables expanded by both."""
    mp = pytest.MonkeyPatch()
    for pf in (JPF, TPF):
        mp.setattr(pf, "TILE_ROWS", TILE)
    _clear()
    try:
        logt = int(np.log2(TPF.tile_rows(N)))
        rng = np.random.default_rng(11)
        blocks = _blocks(rng, logt)
        groups = TPF.materialize_entries(
            blocks, TPF.CAP_STEPS, TPF.CAP_MATS, F32, inplace=True,
            single_class=True, fold_xswap=True)
        assert len(groups) == 1
        cap, sizes, scal, *tabs = groups[0]
        assert [int(r[1]) for r in scal[: len(blocks)]] == [0, 1, 1, 1, 1, 1, 0]
        ja, jb = JPF._get_expander(sizes[0], cap, F32)(
            *(jnp.asarray(t) for t in tabs))
        ta, tb, src = TPF.expand_tables(*(torch.from_numpy(t) for t in tabs))
        yield dict(logt=logt, scal=scal, ja=ja, jb=jb, ta=ta, tb=tb, src=src,
                   halves=_state(rng, N), ptab=JPF.perm_table(F32))
    finally:
        mp.undo()
        _clear()


# index steps are the same exact gathers at every rung: "highest" only
BLOCK_CASES = [(name, "highest") for name in BLOCK_NAMES] + \
    [(name, "high") for name in BLOCK_NAMES if name not in EXACT]


@pytest.mark.parametrize("name,precision", BLOCK_CASES)
def test_split_block_plain_matches_jax_kernels(case, name, precision):
    """Kernel 5(a) (plain rows) and kernel 6 (every row; pair mode on the
    mode-1 rows) against the port's plain version."""
    entry = BLOCK_NAMES.index(name)
    scal = case["scal"][entry]
    args = (case["ta"][entry], case["tb"][entry], case["src"][entry],
            case["logt"], TPF.CAP_STEPS)
    got = KS.run_split_block_plain(scal, _tensors(case["halves"]), *args,
                                   precision=precision)
    routed = KS.run_split_block(scal, _tensors(case["halves"]), *args,
                                precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(routed, got))
    jargs = (jnp.asarray(scal), *(jnp.asarray(h) for h in case["halves"]),
             case["ja"][entry], case["jb"][entry], case["ptab"])
    wants = [JPF.get_stream_split_kernel(N, F32, precision, True)(*jargs)]
    if int(scal[1]) == 0:
        wants.append(JPF.get_split_kernels(N, F32, precision, True)[0](*jargs))
    tol = 0.0 if name in EXACT else TOL if precision == "highest" else HIGH_TOL
    for want in wants:
        assert _max_diff(got, want) <= tol


def test_xswap_plain_matches_jax_and_swap_then_block(case):
    """Kernel 5(b) bit-exact against the pair-grid kernel; and pair mode
    equals the pair swap followed by the plain block, bit for bit."""
    logt = case["logt"]
    shift = 0                  # the tile bit of the case's prologues
    scal = np.zeros(4 + 2 * TPF.CAP_STEPS, dtype=np.int32)
    scal[1:4] = (2, 1 << shift, shift)
    want = JPF.get_split_kernels(N, F32, "highest", True)[1](
        jnp.asarray(scal), *(jnp.asarray(h) for h in case["halves"]))
    got = KS.run_xswap(_tensors(case["halves"]), logt + shift)
    assert _max_diff(got, want) == 0.0
    for entry in range(1, 6):
        row = case["scal"][entry]
        args = (case["ta"][entry], case["tb"][entry], case["src"][entry],
                logt, TPF.CAP_STEPS)
        plain_row = row.copy()
        plain_row[1] = 0
        two = KS.run_split_block(
            plain_row, KS.run_xswap(_tensors(case["halves"]), logt + shift),
            *args)
        one = KS.run_split_block(row, _tensors(case["halves"]), *args)
        assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_split_wrappers_refuse_other_modes_and_devices(case):
    halves = _tensors(case["halves"])
    args = (case["ta"][0], case["tb"][0], case["src"][0], case["logt"],
            TPF.CAP_STEPS)
    for mode in (2, 3, 4, 5):
        row = case["scal"][0].copy()
        row[1] = mode
        with pytest.raises(ValueError, match="split block mode"):
            KS.run_split_block(row, halves, *args)
    meta = tuple(torch.empty(h.shape, device="meta") for h in halves)
    with pytest.raises(ValueError, match="unsupported device"):
        KS.run_split_block(case["scal"][0], meta, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        KS.run_xswap(meta, 2)
    with pytest.raises(ValueError, match="row bit"):
        KS.run_xswap(halves, 3)


def test_high_sync_counters_are_one_buffer_per_stream(monkeypatch):
    """The in-place "high" step's device-memory counters: one zeroed
    buffer per (device, stream handle), so that two streams of one card
    never count on the same ints; the same stream gets the same buffer."""
    monkeypatch.setattr(KS, "_SYNC", {})
    cpu = torch.device("cpu")
    a, b = KS._high_sync(cpu, 11), KS._high_sync(cpu, 12)
    assert a.data_ptr() != b.data_ptr() and KS._high_sync(cpu, 11) is a
    assert a.dtype == torch.int32 and a.shape == (2 * KS.HIGH_SYNC_GROUPS,)
    assert not a.any() and not b.any() and len(KS._SYNC) == 2


# ------------------------------------------------- one set of tables, two chains
@pytest.mark.parametrize("fold", [False, True], ids=["hoisted", "fold_xswap"])
def test_jax_entries_through_both_chains(tiles, monkeypatch, fold):
    """The JAX package's in-place entries (its own hoisting and packing)
    drive the port's SplitChain and the JAX chain on one random state."""
    tiles(TILE, 1)
    monkeypatch.setattr(JPF, "_STREAM_PLAIN", fold)
    n = 12
    ops = j_fuse(JM.grover_like(n, 300, 13), 7, max_high=2)
    prog, parts = _jax_host_parts(ops, n)
    entries = [(part[2], [part[1]], part[3], *part[4:12])
               for part in prog._host_parts]
    halves = _state(np.random.default_rng(5), n)
    chain = TPF.program_from_entries(entries, n, "cpu", inplace=True)
    assert (1 in chain.mode_rows) == fold and (2 in chain.mode_rows) != fold
    got = chain(*_tensors(halves))
    want = prog.run_parts(*(jnp.asarray(h) for h in halves))
    assert _max_diff(got, want) <= TOL


def test_flat_chain_refuses_the_pair_swap(tiles):
    tiles(TILE, 1)
    entries = TPF.materialize_entries(
        [TPF._Block(prologue=(1, 0))], TPF.CAP_STEPS, 2, F32, inplace=True)
    chain = TPF.program_from_entries(entries, N, "cpu")
    x = torch.zeros(1 << N)
    with pytest.raises(ValueError, match="in-place plans"):
        chain(x, x.clone())


# ------------------------------------------------------- the slice as a whole
def _port(**kw):
    return T.Simulator(T.SimulatorConfig(strategy="prefetch", **kw),
                       device="cpu")


@pytest.mark.parametrize("n,gates,seed,portfolio",
                         [(11, 250, 17, False), (12, 300, 13, False),
                          (12, 300, 13, True)])
def test_inplace_simulator_matches_jax_and_reference(tiles, monkeypatch, n,
                                                     gates, seed, portfolio):
    tiles(TILE, 1)
    if portfolio:
        for pf in (JPF, TPF):
            monkeypatch.setattr(pf, "PORTFOLIO_MIN_QUBITS", n)
    c = T.models.grover_like(n, gates, seed)
    jc = JM.grover_like(n, gates, seed)
    got = _port(prefetch_inplace=True, precision="highest").run_detailed(c)
    want = JSimulator(JConfig(strategy="prefetch", prefetch_inplace=True,
                              precision="highest")).run_detailed(jc)
    (prog,) = TPF._RUN_CACHE.values()
    assert prog.inplace and ({2, 3} if n == 12 else {2}) <= set(prog.mode_rows)
    assert got.num_fused_ops == want.num_fused_ops
    assert np.max(np.abs(got.state - want.state)) < TOL
    assert np.max(np.abs(got.state - simulate_reference(jc))) < SIM_TOL


def test_fold_xswap_program_matches_the_hoisted_one(tiles):
    """Both arms of build_prefetch_program on one circuit: the same amplitudes."""
    tiles(TILE, 1)
    n = 12
    ops = t_fuse(T.models.grover_like(n, 300, 13), 7, max_high=2)
    out = []
    for fold in (False, True):
        prog = TPF.build_prefetch_program(ops, n, device="cpu", inplace=True,
                                          fold_xswap=fold)
        out.append(prog.run_parts(*TPF.initial_halves(n, "cpu")))
    assert len(TPF._PROGRAM_CACHE) == 2       # the arm is in the cache key
    assert _max_diff(out[0], [x.numpy() for x in out[1]]) <= TOL
    re, im = TPF.join_halves(*out[0])
    assert abs(float((re.double() ** 2 + im.double() ** 2).sum()) - 1) < 1e-5


def test_run_device_halves_joined_equals_run_device(tiles):
    tiles(TILE, 1)
    c = T.models.grover_like(12, 300, 13)
    sim = _port(prefetch_inplace=True)
    (re0, re1, im0, im1), nops = sim.run_device_halves(c)
    re, im, nops2 = sim.run_device(c)
    assert nops == nops2 and re0.shape == (1 << 4, 128)
    jre, jim = TPF.join_halves(re0, re1, im0, im1)
    assert torch.equal(jre, re) and torch.equal(jim, im)
    # a flat pair through the in-place program splits and joins around it
    (prog,) = TPF._RUN_CACHE.values()
    fre, fim = prog(*initial_state_parts(12, device="cpu"))
    assert torch.equal(fre, re) and torch.equal(fim, im)


@pytest.mark.parametrize("kw", [{}, {"prefetch_inplace": False},
                                {"strategy": "mxu"}], ids=str)
def test_run_device_halves_needs_the_inplace_engine(kw):
    c = T.models.grover_like(10, 40, 1)
    sim = T.Simulator(T.SimulatorConfig(**{"strategy": "prefetch", **kw}),
                      device="cpu")
    with pytest.raises(ValueError, match="run_device_halves requires "
                                         "strategy='prefetch' with the "
                                         "in-place engine"):
        sim.run_device_halves(c)


def test_return_halves_fences():
    c8 = T.models.grover_like(8, 40, 1)
    cfg = T.SimulatorConfig(strategy="prefetch", prefetch_inplace=True)
    with pytest.raises(ValueError, match="split-state halves need"):
        TPF.run_prefetch(c8, cfg, "cpu", return_halves=True)
    flat = T.SimulatorConfig(strategy="prefetch", prefetch_inplace=False)
    with pytest.raises(ValueError, match="return_halves requires the "
                                         "in-place engine"):
        TPF.run_prefetch(T.models.grover_like(10, 40, 1), flat, "cpu",
                         return_halves=True)


def test_inplace_initial_state_resume(tiles):
    """A prefix, then the suffix resumed in place from the complex vector."""
    tiles(TILE, 1)
    n = 11
    full = T.models.grover_like(n, 200, 31)
    first, second = T.Circuit(n), T.Circuit(n)
    first.gates = full.gates[:100]
    second.gates = full.gates[100:]
    sim = _port(prefetch_inplace=True)
    mid = sim.run(first)
    got = sim.run(second, initial=mid)
    assert np.max(np.abs(got - simulate_reference(
        JM.grover_like(n, 200, 31)))) < SIM_TOL
    parts, _ = sim.run_device_halves(second,
                                     initial_parts=(mid.real, mid.imag))
    re, im = TPF.join_halves(*parts)
    assert np.array_equal(re.numpy() + 1j * im.numpy(), got)
    with pytest.raises(ValueError, match="wrong length"):
        sim.run_device_halves(second,
                              initial_parts=(mid.real[:-1], mid.imag[:-1]))


def _as_halves(v):
    x = v.reshape(-1, TPF.DVIEW)
    lanes = TPF.LANES
    return [np.ascontiguousarray(h) for h in
            (x.real[:, :lanes], x.real[:, lanes:],
             x.imag[:, :lanes], x.imag[:, lanes:])]


@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("form", ["pair", "halves", "pair_tensor",
                                  "halves_tensor"])
def test_run_device_halves_initial_parts(tiles, form, permute):
    """``initial_parts`` as a flat (re, im) pair or the four column halves,
    numpy or tensors on the simulator's device, equals ``run(initial=)``
    (the JAX package's forms).  The plan relabels the qubits, with swaps
    of flat bit 7 among them, so the four halves are relabeled in place."""
    tiles(TILE, 1)
    n = 11
    full = T.models.grover_like(n, 200, 31)
    first, second = T.Circuit(n), T.Circuit(n)
    first.gates = full.gates[:100]
    second.gates = full.gates[100:]
    sim = _port(prefetch_inplace=True, permute=permute)
    mid = sim.run(first)
    want = sim.run(second, initial=mid)
    parts = ([mid.real, mid.imag] if form.startswith("pair")
             else _as_halves(mid))
    if form.endswith("tensor"):
        parts = [torch.tensor(p, dtype=torch.float32) for p in parts]
    held = [p.clone() if isinstance(p, torch.Tensor) else p.copy()
            for p in parts]
    got, _ = sim.run_device_halves(second, initial_parts=tuple(parts))
    re, im = TPF.join_halves(*got)
    assert np.array_equal(re.numpy() + 1j * im.numpy(), want)
    assert np.max(np.abs(want - simulate_reference(
        JM.grover_like(n, 200, 31)))) < SIM_TOL
    # the caller's arrays are copied, never changed (tensors on the
    # simulator's device too), so the same state resumes twice alike
    assert all(np.array_equal(np.asarray(p), np.asarray(h))
               for p, h in zip(parts, held))
    again, _ = sim.run_device_halves(second, initial_parts=tuple(parts))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_initial_parts_relabel_halves_matches_flat():
    """``start_halves`` relabels four halves without a flat tensor, and
    agrees with the flat relabel (``start_pair``) for every bit exchange,
    bit 7 (the half) included; the JAX package's error forms."""
    rng = np.random.default_rng(5)
    n = 10
    v = (rng.standard_normal(1 << n)
         + 1j * rng.standard_normal(1 << n)).astype(np.complex64)
    for perm in (np.arange(n), rng.permutation(n), rng.permutation(n),
                 np.array([7, 0, 1, 2, 3, 4, 5, 6, 8, 9])):
        re, im = TPF.start_pair((v.real, v.imag), n, "cpu", perm)
        want = _as_halves(re.numpy() + 1j * im.numpy())
        for parts in (_as_halves(v), (v.real, v.imag)):
            got = TPF.start_halves(parts, n, "cpu", perm)
            assert all(np.array_equal(g.numpy(), w)
                       for g, w in zip(got, want))
            # float32 tensors on the device: copied, never changed, and
            # the engine's buffers share no memory with them
            given = [torch.tensor(p) for p in parts]
            held = [p.clone() for p in given]
            got = TPF.start_halves(given, n, "cpu", perm)
            assert all(np.array_equal(g.numpy(), w)
                       for g, w in zip(got, want))
            assert all(torch.equal(p, h) for p, h in zip(given, held))
            mine = {g.untyped_storage().data_ptr() for g in got}
            assert not mine & {p.untyped_storage().data_ptr()
                               for p in given}
    with pytest.raises(ValueError, match="flat \\(re, im\\) pair or the four"):
        TPF.start_halves((v.real,), n, "cpu")
    with pytest.raises(ValueError, match="wrong length"):
        TPF.start_halves(_as_halves(v)[:2] + [v.real[:8], v.imag[:8]], n,
                         "cpu")


@pytest.mark.parametrize("inplace", [False, True], ids=["flat", "inplace"])
@pytest.mark.parametrize("n", [12, 28, 29, 30, 31])
def test_inplace_knobs_and_mono_lowering_follow_jax(monkeypatch, n, inplace):
    for pf in (JPF, TPF):
        monkeypatch.setattr(pf, "MONO_AS_MAT", None)
    assert TPF.resolve_prefetch_knobs(
        T.SimulatorConfig(strategy="prefetch"), n, inplace) == \
        JPF.resolve_prefetch_knobs(JConfig(strategy="prefetch"), n, inplace)
    port = TPF.resolve_mono_as_mat(n, inplace)
    jax = JPF.resolve_mono_as_mat(n, inplace)
    if inplace and n >= 29:
        # the card policy: the card runs every in-place step as a launch
        # and a state pass of its own, so a mono step (one gather pass)
        # beats the rung's dense product at every width; the JAX package's
        # mats from n = 29 rest on TPU blocks sharing one pass in VMEM
        assert jax and not port
    else:
        assert port == jax
    # sharded plans keep the mono step in both packages
    assert TPF.resolve_mono_as_mat(n, inplace, num_global=2) is False
    assert JPF.resolve_mono_as_mat(n, inplace, num_global=2) is False


def test_prefetch_goes_in_place_from_n30():
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cpu")
    assert sim._prefetch_inplace(30) and not sim._prefetch_inplace(29)


def test_inplace_entries_equal_jax_under_the_forced_mat_arm(tiles,
                                                            monkeypatch):
    """Forced to lower monos as mats, the in-place program still packs the
    JAX package's arrays: plan parity keeps a guard on that arm."""
    tiles(TILE, 1)
    for pf in (JPF, TPF):
        monkeypatch.setattr(pf, "MONO_AS_MAT", True)
    jops = j_fuse(JM.grover_like(12, 300, 13), 7, max_high=2)
    tops = t_fuse(T.models.grover_like(12, 300, 13), 7, max_high=2)
    _, want = _jax_host_parts(jops, 12)
    got = TPF.PrefetchProgram(tops, 12, device="cpu", inplace=True)._chain._parts
    assert len(got) == len(want)
    for (gscal, gtabs), (wscal, wtabs) in zip(got, want):
        assert np.array_equal(np.asarray(gscal, dtype=np.int32), wscal)
        for g, w in zip(gtabs, wtabs):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    plan = TPF.plan_circuit(tops, 12, involution_relayout=True)
    kinds = [k for b in plan.blocks for k in b.kinds]
    assert plan.mono_as_mat and plan.logt + 2 not in kinds


def _run_counted(ops, n, start):
    """The in-place program's run of ``ops`` from the halves ``start`` on
    the CPU at "high": (halves, plan's step kinds, the step counters)."""
    plan = TPF.plan_circuit(ops, n, involution_relayout=True)
    prog = TPF.PrefetchProgram(ops, n, precision="high", device="cpu",
                               inplace=True)
    telemetry.reset()
    got = prog.run_parts(*_tensors(start))
    counts = telemetry.counters()
    return (got, [k for b in plan.blocks for k in b.kinds], plan.logt,
            {k: counts.get(k, 0) for k in ("inplace_mat_steps",
                                          "inplace_mono_steps")})


def test_inplace_step_counters_and_both_mono_arms(tiles, monkeypatch):
    """In place the port lowers monos as mono steps; the chain counts the
    plan's mat and mono steps under either arm, and the two arms' states
    agree within the "high" rung."""
    tiles(TILE, 1)
    n = 12
    ops = t_fuse(T.models.grover_like(n, 300, 13), 7, max_high=2)
    start = _state(np.random.default_rng(7), n)
    states = {}
    for arm in (None, True, False):
        monkeypatch.setattr(TPF, "MONO_AS_MAT", arm)
        got, kinds, logt, counts = _run_counted(ops, n, start)
        assert counts == {"inplace_mat_steps": kinds.count(0),
                          "inplace_mono_steps": kinds.count(logt + 2)}
        assert (counts["inplace_mono_steps"] == 0) == (arm is True)
        assert counts["inplace_mat_steps"] > 0
        states[arm] = got
    assert _max_diff(states[None], states[False]) == 0.0
    assert _max_diff(states[True], [g.numpy() for g in states[False]]) \
        <= HIGH_TOL


def test_inplace_n30_plan_lowers_monos_as_mono_steps(monkeypatch):
    """The benchmark circuit in place at n = 30: 144 mat and 548 mono
    steps under the auto arm (692 mats under the forced one)."""
    from gpu_quantum_simulator_tpu_torch import profiling

    monkeypatch.setattr(TPF, "MONO_AS_MAT", None)
    got = profiling.plan_counts(30, inplace=True)
    assert not got["mono_as_mat"]
    assert (got["mat_steps"], got["mono_steps"]) == (144, 548)
    assert got["mat_steps"] + got["mono_steps"] == got["fused_ops"] == 692
