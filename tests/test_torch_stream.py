"""The folded relayout (scal mode 5) of the port against the JAX package.

From n = 23 the JAX package merges a standalone relayout into the next
plain block (``_fold_relayout_entries``), whose streamed input copies read
through the relayout's sigma (``get_stream_block_kernel``).  The port's
block reads its input through sigma in its first launch; its plain version
is the relayout followed by the steps.  Here:

* the fold pass itself, as the JAX package's own unit test checks it;
* ``run_block_plain`` in mode 5 against the relayout then the steps
  (bit-exact), and against the JAX stream kernel in interpret mode on the
  same tables and state, for each kind of first step and both rungs;
* whole circuits at shrunken tiles with the fold and the portfolio
  switched on at n (the thresholds monkeypatched in both packages): the
  port's Simulator on the CPU against the JAX ``PrefetchProgram``
  (interpret mode) and the f64 reference, and the JAX package's folded
  entries run through the port's ``program_from_entries``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu.engine.simulator import _fuse_pipeline as j_fuse
from gpu_quantum_simulator_tpu.ops.apply import initial_state_parts, join_state
from gpu_quantum_simulator_tpu.passes.permute import unpermute_state
from gpu_quantum_simulator_tpu.ref.cpu import simulate_reference

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.kernels.block import (
    run_block, run_block_plain)
from gpu_quantum_simulator_tpu_torch.kernels.relayout import run_relayout_plain

TOL = 1e-6           # the fold's end-to-end bar (f64 reference, JAX engine)
KERNEL_TOL = 1e-5    # f32 products summed in another order than the JAX dot
# "high": the port's schoolbook 3-pass product against the JAX Karatsuba
# 3-pass product, whose combined operands (x_re + x_im, b - a, a + b) are
# split to bf16 after the add: both are ~2^-17 relative per product
HIGH_KERNEL_TOL = 1e-4

N = 11
TILE, TR = 4, 1


def _clear():
    for cache in (JPF._KERNEL_CACHE, JPF._CHAIN_CACHE, JPF._PROGRAM_CACHE,
                  JPF._RUN_CACHE, TPF._PROGRAM_CACHE, TPF._RUN_CACHE):
        cache.clear()


def _unitary(rng, d):
    q, r = np.linalg.qr(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _monomial(rng, d):
    u = np.zeros((d, d), dtype=complex)
    u[np.arange(d), rng.permutation(d)] = np.exp(
        1j * rng.uniform(-np.pi, np.pi, d))
    return u


# ------------------------------------------------------------ fold pass
def test_fold_relayout_entries_unit():
    """Mirror of the JAX package's unit test on the port's blocks."""
    sig = np.array([1, 0], dtype=np.int32)

    def mk_plain():
        return TPF._Block(kinds=[0], midx=[0], mats=[(np.eye(2), (0,), None)])

    out = TPF._fold_relayout_entries([TPF._Block(relayout=sig), mk_plain()])
    assert len(out) == 1
    assert out[0].relayout_pro is sig and out[0].kinds == [0]
    assert out[0].relayout is None
    # next block already carries an xswap prologue: no fold
    pro = mk_plain()
    pro.prologue = (1, 0)
    out = TPF._fold_relayout_entries([TPF._Block(relayout=sig), pro])
    assert len(out) == 2 and out[0].relayout is sig
    # trailing relayout stays standalone
    out = TPF._fold_relayout_entries([mk_plain(), TPF._Block(relayout=sig)])
    assert len(out) == 2 and out[1].relayout is sig
    # back-to-back relayouts: only the second can fold forward
    out = TPF._fold_relayout_entries(
        [TPF._Block(relayout=sig), TPF._Block(relayout=sig), mk_plain()])
    assert len(out) == 2
    assert out[0].relayout is sig and out[1].relayout_pro is sig
    # modes stay exclusive: a folded block never carries a prologue
    assert all(b.prologue is None for b in out if b.relayout_pro is not None)


# ------------------------------------------------- one folded block
FIRST_STEPS = ("mat", "tswap1", "tswap2", "perm", "mono")


@pytest.fixture(scope="module")
def folded():
    """Shrunken tiles in both packages (n=11: 8 rows, T=4, Tr=1, three
    row-block bits); one folded block per kind of first step, each followed
    by a mat step, packed once by the port's materialize_entries."""
    mp = pytest.MonkeyPatch()
    for pf in (JPF, TPF):
        mp.setattr(pf, "TILE_ROWS", TILE)
        mp.setattr(pf, "RELAYOUT_TILE_ROWS", TR)
    _clear()
    try:
        rng = np.random.default_rng(23)
        logt = int(np.log2(TPF.tile_rows(N)))
        R2 = 1 << (N - TPF.LOCAL_QUBITS)
        mrow = int(np.log2(R2 // TR))
        sigma = np.array([2, 0, 1], dtype=np.int32)

        def mat(width, mono=False):
            d = 1 << width
            u = _monomial(rng, d) if mono else _unitary(rng, d)
            pos = tuple(int(p) for p in
                        rng.permutation(TPF.LOCAL_QUBITS)[:width])
            return (u, pos, None)

        first = {"mat": (0, mat(7)), "tswap1": (1, 0), "tswap2": (logt, 0),
                 "perm": (logt + 1, 3), "mono": (logt + 2, mat(5, True))}
        blocks = []
        for name in FIRST_STEPS:
            kind, arg = first[name]
            b = TPF._Block(relayout_pro=sigma)
            if kind in (0, logt + 2):
                b.kinds, b.midx, b.mats = [kind, 0], [0, 1], [arg, mat(3)]
            else:
                b.kinds, b.midx, b.mats = [kind, 0], [arg, 0], [mat(3)]
            blocks.append(b)
        (cap, sizes, scal, *tabs), = TPF.materialize_entries(
            blocks, TPF.CAP_STEPS, TPF.CAP_MATS, np.float32)
        assert (scal[: len(blocks), 1] == 5).all()
        soff = 4 + 2 * TPF.CAP_STEPS
        assert np.array_equal(scal[0, soff : soff + mrow], sigma)
        re = rng.standard_normal((R2, TPF.DVIEW)).astype(np.float32)
        im = rng.standard_normal((R2, TPF.DVIEW)).astype(np.float32)
        ja, jb = JPF._get_expander(sizes[0], cap, np.float32)(
            *(jnp.asarray(t) for t in tabs))
        ta, tb, src = TPF.expand_tables(*(torch.from_numpy(t) for t in tabs))
        ptab = JPF.perm_table(np.float32)
        jout = {}
        for rung in ("highest", "high"):
            kernel = JPF.get_stream_block_kernel(N, np.float32, rung, True,
                                                 TPF.CAP_STEPS, cap)
            jout[rung] = [tuple(np.asarray(x) for x in kernel(
                jnp.asarray(scal[i]), jnp.asarray(re), jnp.asarray(im),
                ja[i], jb[i], ptab)) for i in range(len(blocks))]
        yield dict(logt=logt, scal=scal, sigma=sigma, re=re, im=im, ta=ta,
                   tb=tb, src=src, jout=jout)
    finally:
        mp.undo()
        _clear()


def _args(case, i):
    return (case["ta"][i], case["tb"][i], case["src"][i], case["logt"],
            TPF.CAP_STEPS)


@pytest.mark.parametrize("rung", ["highest", "high"])
@pytest.mark.parametrize("first", FIRST_STEPS)
def test_plain_folded_block_is_relayout_then_steps(folded, first, rung):
    i = FIRST_STEPS.index(first)
    scal = folded["scal"][i]
    re, im = torch.from_numpy(folded["re"]), torch.from_numpy(folded["im"])
    got = run_block_plain(scal, re, im, *_args(folded, i),
                          sigma=folded["sigma"], tr=TR, precision=rung)
    plain = scal.copy()
    plain[1] = 0
    moved = run_relayout_plain(folded["sigma"], re, im, TR)
    want = run_block_plain(plain, *moved, *_args(folded, i), precision=rung)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # on a CPU tensor the wrapper is the plain version
    routed = run_block(scal, re, im, *_args(folded, i),
                       sigma=folded["sigma"], tr=TR, precision=rung)
    assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])


@pytest.mark.parametrize("rung", ["highest", "high"])
@pytest.mark.parametrize("first", FIRST_STEPS)
def test_plain_folded_block_matches_jax_stream_kernel(folded, first, rung):
    i = FIRST_STEPS.index(first)
    re, im = torch.from_numpy(folded["re"]), torch.from_numpy(folded["im"])
    got = run_block_plain(folded["scal"][i], re, im, *_args(folded, i),
                          sigma=folded["sigma"], tr=TR, precision=rung)
    want = folded["jout"][rung][i]
    tol = KERNEL_TOL if rung == "highest" else HIGH_KERNEL_TOL
    assert np.max(np.abs(got[0].numpy() - want[0])) <= tol
    assert np.max(np.abs(got[1].numpy() - want[1])) <= tol


def test_folded_block_needs_its_sigma(folded):
    re, im = torch.from_numpy(folded["re"]), torch.from_numpy(folded["im"])
    with pytest.raises(ValueError, match="sigma"):
        run_block_plain(folded["scal"][0], re, im, *_args(folded, 0))


# --------------------------------------------------- whole circuits
@pytest.fixture
def fold_at(monkeypatch):
    """Tiles (t, tr) and the fold + portfolio thresholds set to n in both
    packages, caches cleared."""
    def setup(n, t, tr):
        for pf in (JPF, TPF):
            monkeypatch.setattr(pf, "TILE_ROWS", t)
            monkeypatch.setattr(pf, "RELAYOUT_TILE_ROWS", tr)
            monkeypatch.setattr(pf, "STREAM_RELAYOUT_MIN_QUBITS", n)
            monkeypatch.setattr(pf, "PORTFOLIO_MIN_QUBITS", n)
        _clear()

    yield setup
    _clear()


GEOMETRIES = [(12, 4, 1), (13, 8, 2)]


@pytest.mark.parametrize("n,t,tr", GEOMETRIES)
def test_folded_circuit_matches_jax_and_reference(fold_at, n, t, tr):
    fold_at(n, t, tr)
    c = T.models.grover_like(n, 300, 13)
    jc = JM.grover_like(n, 300, 13)
    got = T.Simulator(T.SimulatorConfig(strategy="prefetch"),
                      device="cpu").run(c)
    (prog,) = TPF._RUN_CACHE.values()
    assert prog.mode_rows.get(5, 0) > 0, prog.mode_rows

    ops = j_fuse(jc, 7, max_high=2)
    jprog = JPF.PrefetchProgram(ops, n, interpret=True)
    re, im = jprog(*initial_state_parts(n, dtype=np.float32))
    jstate = unpermute_state(join_state(np.asarray(re), np.asarray(im)),
                             jprog.final_position)
    ref = simulate_reference(jc)
    assert np.max(np.abs(jstate - ref)) < TOL
    assert np.max(np.abs(got - jstate)) < TOL
    assert np.max(np.abs(got - ref)) < TOL


@pytest.mark.parametrize("n,t,tr", GEOMETRIES)
def test_jax_folded_entries_through_port_chain(fold_at, n, t, tr):
    """The JAX package's plan and folded tables, run by the port."""
    fold_at(n, t, tr)
    jc = JM.grover_like(n, 300, 13)
    ops = j_fuse(jc, 7, max_high=2)
    plan = JPF.plan_prefetch_best(ops, n)
    entries = JPF.materialize_entries(
        plan.blocks, JPF.CAP_STEPS, JPF.CAP_MATS, np.float32,
        fold_relayout=JPF.resolve_stream_relayout(n),
        mono_as_mat=plan.mono_as_mat)
    rows = np.concatenate([e[2] for e in entries])
    assert (rows[:, 1] == 5).sum() > 0
    chain = TPF.program_from_entries(entries, n, "cpu")
    re = torch.zeros(1 << n)
    re[0] = 1.0
    re, im = chain(re, torch.zeros(1 << n))
    state = unpermute_state(re.numpy() + 1j * im.numpy(), plan.final_position)
    assert chain.mode_rows[5] == (rows[:, 1] == 5).sum()
    assert np.max(np.abs(state - simulate_reference(jc))) < TOL
