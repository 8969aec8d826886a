"""The port's ``mxu`` strategy (the wide engine) against the JAX package.

Fusion with the cost model (native and Python), the wide program's host
half (``_op_spec``, ``row_shuffles``, step lists, tables), the chain
kernel's plain version against the JAX kernel 7 in interpret mode,
amplitudes of ``Simulator(strategy="mxu", device="cpu")`` against the JAX
package's mxu Simulator, the "high" rung, the device unpermute and the
fences of the slice.  Each test states its tolerance.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import simulator as JS
from gpu_quantum_simulator_tpu.engine import wide as JW
from gpu_quantum_simulator_tpu.ir.circuit import Circuit as JCircuit
from gpu_quantum_simulator_tpu.ops import apply as JA
from gpu_quantum_simulator_tpu.passes.permute import (
    plan_permutation as j_plan_permutation)

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import simulator as TS
from gpu_quantum_simulator_tpu_torch.engine import wide as TW
from gpu_quantum_simulator_tpu_torch.ir.oplist import Op
from gpu_quantum_simulator_tpu_torch.kernels import wide as KW
from gpu_quantum_simulator_tpu_torch.ops import apply as TA
from gpu_quantum_simulator_tpu_torch.passes.permute import plan_permutation
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

MAT_TOL = 1e-12      # fused matrices: the same f64 products, another build
AMP_TOL = 1e-6       # "highest" amplitudes (BASELINE.md bar)
HIGH_TOL = 4e-6      # the "high" rung's bar (tests/test_precision_auto.py:68)
# peak |amplitude| of grover_like(12, 600, 41), the state that bar was set
# on; a state whose amplitudes are larger carries proportionally larger
# rounding, so the bar scales with the peak (the low-only circuit's state
# sits on 128 amplitudes, peak 0.234)
HIGH_BAR_PEAK = 0.0486


def high_tol(state):
    return HIGH_TOL * max(1.0, float(np.max(np.abs(state))) / HIGH_BAR_PEAK)


def low_only(cls, n, gates, seed=3):
    """tests/test_precision_auto.py:79-91: gates on qubits 0..6 only, so
    every fused block is kh = 0."""
    rng = np.random.default_rng(seed)
    c = cls(n)
    for _ in range(gates):
        kind = rng.integers(3)
        q = int(rng.integers(7))
        if kind == 0:
            c.h(q)
        elif kind == 1:
            c.rz(float(rng.uniform(-3, 3)), q)
        else:
            r = int(rng.integers(7))
            if r != q:
                c.cx(q, r)
    return c


def mixed(cls, n, seed=41):
    """A low-heavy circuit with a few high-qubit gates (tests/test_engines.py
    test_wide_kh0_pallas_parity): kh0 runs and mm steps interleave."""
    low = (JM if cls is JCircuit else T.models).grover_like(7, 260, seed)
    c = cls(n)
    for i, g in enumerate(low.gates):
        c.gates.append(g)
        if i % 40 == 39:
            c.cx(7, 8).cx(8, 9).h(7)
    return c


def _relabeled(c):
    return c.relabeled(j_plan_permutation(c) if isinstance(c, JCircuit)
                       else plan_permutation(c))


def assert_same_ops(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.kind == b.kind and tuple(a.qubits) == tuple(b.qubits)
        assert np.max(np.abs(np.asarray(a.u) - np.asarray(b.u))) <= MAT_TOL


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("n", [10, 18, 24])
def test_cost_model_fusion_matches_jax(n, native, monkeypatch):
    """The mxu engine's fusion (relabeled circuit, window 8, max_high 2,
    the kh cost model): the same ops as the JAX package, native and
    Python alike.  Plans only; no state."""
    gates = 2445 if native else 600
    tc = _relabeled(T.models.grover_like(n, gates, 318))
    jc = _relabeled(JM.grover_like(n, gates, 318))
    if not native:
        monkeypatch.setattr(TS, "_NATIVE_FUSE", False)
        monkeypatch.setattr(JS, "_NATIVE_FUSE", False)
    got = TS._fuse_pipeline(tc, 7, max_high=2, window=8, cost_model=True)
    want = JS._fuse_pipeline(jc, 7, max_high=2, window=8, cost_model=True)
    assert_same_ops(got, want)
    # the cost model packs every low gate into a kh >= 1 block here
    assert all(any(q >= 7 for q in op.qubits) for op in got)


def test_low_only_fusion_runs():
    """max_fused_qubits 3 / 4 on the low-only circuit at n = 24 (600 gates,
    seed 3): 69 kh0 ops in nine P = 8 runs, and 51 in six P = 8 runs and one
    P = 4 — the same ops as the JAX package's."""
    for k, nops, runs in ((3, 69, [8] * 9), (4, 51, [8] * 6 + [4])):
        tc = _relabeled(low_only(T.Circuit, 24, 600))
        ops = TS._fuse_pipeline(tc, k, max_high=2, window=8, cost_model=True)
        jops = JS._fuse_pipeline(_relabeled(low_only(JCircuit, 24, 600)), k,
                                 max_high=2, window=8, cost_model=True)
        assert_same_ops(ops, jops)
        prog = TW.WideProgram(ops, 10, device="cpu")
        assert len(ops) == nops
        assert [st[2] for seg in prog.segments for st in seg.steps] == runs


def test_op_spec_matches_jax():
    n = 12
    c = _relabeled(T.models.grover_like(n, 400, 5))
    ops = TS._fuse_pipeline(c, 7, max_high=2, window=8, cost_model=True)
    ops += [Op("cx", (9, 2)), Op("cx", (1, 3))]
    for op in ops:
        got = TW._op_spec(op, n)
        jop = JW.Op(op.kind, op.qubits, op.u)
        want = JW._op_spec(jop, n)
        assert got[:3] == want[:3]
        assert np.array_equal(got[3], want[3]) and np.array_equal(got[4], want[4])


@pytest.mark.parametrize("row_bits", [(), (0,), (3,), (0, 1), (1, 4), (2, 5)])
def test_row_shuffles_match_jax(row_bits):
    R = 64
    x = np.random.default_rng(1).standard_normal((R, 128)).astype(np.float32)
    fwd, bwd = TW.row_shuffles(row_bits, R)
    jfwd, jbwd = JW.row_shuffles(row_bits, R)
    t = fwd(torch.from_numpy(x))
    assert np.array_equal(t.numpy(), np.asarray(jfwd(jnp.asarray(x))))
    assert np.array_equal(bwd(t).numpy(), x)


def _jax_segments(prog):
    """(steps, mats) of each segment of a JAX WideProgram, from the closure
    of its segment kernels."""
    out = []
    for kern, mats in prog._raw_segments:
        steps = inspect.getclosurevars(kern).nonlocals["steps"]
        out.append((steps, mats))
    return out


@pytest.mark.parametrize("case", ["mixed", "low_only_k3", "grover",
                                  "low_only_n9"])
def test_wide_program_steps_match_jax(case):
    """Step lists per segment and ``num_kh0_runs`` equal the JAX package's
    with ``kh0_pallas=True`` at n = 10 (the port chains kh = 0 blocks
    whenever R >= 8) and ``kh0_pallas=False`` at n = 9 (R = 4: no chain);
    the mm tables (Karatsuba combinations) equal its float32 tables
    exactly; the kh0 runs hold the blocks' M."""
    n = 9 if case == "low_only_n9" else 10
    if case == "low_only_n9":
        tc, jc, k, cost = (low_only(T.Circuit, n, 200),
                           low_only(JCircuit, n, 200), 3, True)
    elif case == "mixed":
        tc, jc, k, cost = mixed(T.Circuit, n), mixed(JCircuit, n), 7, False
    elif case == "low_only_k3":
        tc, jc, k, cost = (low_only(T.Circuit, n, 600),
                           low_only(JCircuit, n, 600), 3, True)
    else:
        tc, jc, k, cost = (T.models.grover_like(n, 2445, 318),
                           JM.grover_like(n, 2445, 318), 7, True)
    ops = TS._fuse_pipeline(tc, k, max_high=2, window=8, cost_model=cost)
    jops = JS._fuse_pipeline(jc, k, max_high=2, window=8, cost_model=cost)
    prog = TW.WideProgram(ops, n, device="cpu")
    jprog = JW.WideProgram(jops, n, jnp.float32, kh0_pallas=n >= 10)
    assert prog.num_kh0_runs == jprog.num_kh0_runs
    if case in ("mixed", "low_only_k3"):
        assert prog.num_kh0_runs > 0
    jsegs = _jax_segments(jprog)
    assert len(prog.segments) == len(jsegs)
    for seg, (jsteps, jmats) in zip(prog.segments, jsegs):
        assert seg.steps == jsteps
        for i, D in enumerate(sorted(seg.mm)):
            for c in range(3):
                assert np.array_equal(seg.mm[D][:, c].numpy(),
                                      np.asarray(jmats[3 * i + c]))
    # a kh0 run's tables are the blocks' M in order (no identity pads)
    kh0 = [s for s in (TW._op_spec(op, n) for op in ops) if s[0] == 0]
    runs = [r for seg in prog.segments for r in seg.runs]
    if n < 10:
        assert kh0 and not runs     # R < 8: kh = 0 blocks are mm steps
        return
    flat = torch.cat(runs) if kh0 else torch.zeros(0, 2, 128, 128)
    assert flat.shape[0] == len(kh0)
    for t, s in zip(flat, kh0):
        assert np.array_equal(t[0].numpy(), s[3].astype(np.float32))
        assert np.array_equal(t[1].numpy(), s[4].astype(np.float32))


@pytest.mark.parametrize("case", ["mixed", "low_only_k3"])
def test_wide_program_high_run_tables(case):
    """At "high" the port's WideProgram holds, for every kh = 0 run, the
    ``split_mm_tables`` image of the run's Karatsuba combinations formed in
    float64: ``mm_tables_f32`` reads each product's image back to the JAX
    package's float32 combinations of that run (its kernel 7 tables,
    without the identity pads) rounded to bf16 (hi, lo), bit for bit; at
    "highest" no run has an image."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import bf16_split

    n = 10
    if case == "mixed":
        tc, jc, k, cost = mixed(T.Circuit, n), mixed(JCircuit, n), 7, False
    else:
        tc, jc, k, cost = (low_only(T.Circuit, n, 600),
                           low_only(JCircuit, n, 600), 3, True)
    ops = TS._fuse_pipeline(tc, k, max_high=2, window=8, cost_model=cost)
    jops = JS._fuse_pipeline(jc, k, max_high=2, window=8, cost_model=cost)
    prog = TW.WideProgram(ops, n, precision="high", device="cpu")
    jprog = JW.WideProgram(jops, n, jnp.float32, kh0_pallas=True)
    checked = 0
    for seg, (jsteps, jmats) in zip(prog.segments, _jax_segments(jprog)):
        first = 3 * len(seg.mm)         # the JAX runs follow the mm tables
        assert len(seg.runs_w16) == len(seg.runs)
        for r, (tabs, w16) in enumerate(zip(seg.runs, seg.runs_w16)):
            L = tabs.shape[0]
            assert w16.shape == (L, 6 * 128 * 128)
            assert w16.dtype == torch.bfloat16
            for j in range(L):
                back = KW.mm_tables_f32(w16[j])
                for c in range(3):
                    m = torch.from_numpy(np.array(
                        jmats[first + 3 * r + c][j]))
                    hi, lo = bf16_split(m)
                    assert torch.equal(back[2 * c].view(torch.int32),
                                       hi.view(torch.int32))
                    assert torch.equal(back[2 * c + 1].view(torch.int32),
                                       lo.view(torch.int32))
                checked += 1
    assert checked == sum(t.shape[0] for seg in prog.segments
                          for t in seg.runs) > 0
    low = TW.WideProgram(ops, n, precision="highest", device="cpu")
    assert all(w is None for seg in low.segments for w in seg.runs_w16)


@pytest.mark.parametrize("case", ["mixed", "low_only_k3"])
def test_wide_program_default_run_tables(case):
    """At "default" each kh = 0 run's chain tables are the hi-only image
    (``split_mm_tables_hi``, (L, 3 * 128^2)), word for word the hi parts of
    the "high" program's (L, 6 * 128^2) image of the same run; and the
    "default" program, whose chains read them, is step by step the plain
    versions on the same images: the chain of each run and the mm steps,
    bit for bit."""
    n = 10
    tc, k, cost = ((mixed(T.Circuit, n), 7, False) if case == "mixed"
                   else (low_only(T.Circuit, n, 600), 3, True))
    ops = TS._fuse_pipeline(tc, k, max_high=2, window=8, cost_model=cost)
    progs = {rung: TW.WideProgram(ops, n, precision=rung, device="cpu")
             for rung in ("high", "default")}
    runs = 0
    for dseg, hseg in zip(progs["default"].segments,
                          progs["high"].segments):
        for d, h in zip(dseg.runs_w16, hseg.runs_w16):
            assert d.dtype == torch.bfloat16
            assert d.shape == (h.shape[0], 3 * 128 * 128)
            assert h.shape == (h.shape[0], 6 * 128 * 128)
            assert torch.equal(d, KW.mm_hi_image(h))
            runs += 1
    assert runs == progs["default"].num_kh0_runs > 0
    rng = np.random.default_rng(11)
    v = rng.standard_normal((2, 1 << n))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    got = progs["default"](torch.from_numpy(v[0].copy()),
                           torch.from_numpy(v[1].copy()))
    R = 1 << (n - 7)
    x = (torch.from_numpy(v[0]).reshape(R, 128),
         torch.from_numpy(v[1]).reshape(R, 128))
    for seg in progs["default"].segments:
        for st in seg.steps:
            if st[0] == "kh0":
                x = KW.kh0_chain_plain(*x, seg.runs[st[1]], "default",
                                       w16=seg.runs_w16[st[1]])
            else:
                _, D, idx, bits = st
                x = KW.mm_step_default_plain(*x, seg.mm[D][idx], bits)
    assert all(torch.equal(g, w.reshape(-1)) for g, w in zip(got, x))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_carried_ops_through_both_programs(precision):
    """The JAX package's fused ops, rebuilt as the port's ``Op`` from their
    numpy qubits and matrices, run through the port's WideProgram (plain
    chain) and the JAX one (kernel 7 in interpret mode) on one random
    normalized state."""
    n = 10
    jops = JS._fuse_pipeline(mixed(JCircuit, n), 7, max_high=2, window=8)
    ops = [Op(o.kind, tuple(int(q) for q in o.qubits),
              None if o.u is None else np.asarray(o.u)) for o in jops]
    rng = np.random.default_rng(7)
    v = rng.standard_normal((2, 1 << n))
    v /= np.linalg.norm(v)
    v = v.astype(np.float32)
    prog = TW.WideProgram(ops, n, precision=precision, device="cpu")
    got = prog(torch.from_numpy(v[0].copy()), torch.from_numpy(v[1].copy()))
    jprog = JW.WideProgram(jops, n, jnp.float32, precision=precision,
                           kh0_pallas=True)
    want = jprog(jnp.asarray(v[0]), jnp.asarray(v[1]))
    tol = AMP_TOL if precision == "highest" else HIGH_TOL
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= tol


def _unitaries(rng, count):
    out = []
    for _ in range(count):
        q, r = np.linalg.qr(rng.standard_normal((128, 128))
                            + 1j * rng.standard_normal((128, 128)))
        out.append(q * (np.diag(r) / np.abs(np.diag(r))))
    return out


# At "high" kh0_chain_plain and the JAX kernel take the same Karatsuba
# combinations and the same bf16 split, so one product differs only in the
# order of its fp32 sums: readings <= 1.12e-8 (3 fp32 ulps at the states'
# peak |amp| ~0.044) on the CPU these tests were written on; the bar allows
# 8.  A chain of them does not keep that bar: the split is discontinuous,
# so an ulp of difference in a product's input can move a value's bf16
# (hi, lo) split and with it the term the 3-pass product drops (xl.ml,
# ~2^-16 of the product); the two chains part by up to 5.6e-7 after 8
# products, so the whole chain is held to the rung's 4e-6.
HIGH_ORDER_TOL = 3e-8


def _karatsuba_combos(us):
    """(P, 3, 128, 128) float32: m1 = M_re^T, m2 = (M_im - M_re)^T, m3 =
    (M_re + M_im)^T of each unitary, formed in float64 as the JAX engine
    forms them."""
    return np.stack([np.stack([u.real.T, (u.imag - u.real).T,
                               (u.real + u.imag).T])
                     for u in us]).astype(np.float32)


@pytest.mark.parametrize("precision,tol", [("highest", 1e-6), ("high", 4e-6)])
@pytest.mark.parametrize("P", [1, 8])
def test_kh0_chain_plain_matches_jax_kernel(P, precision, tol):
    """kh0_chain_plain (Karatsuba at both rungs) against get_kh0_kernel in
    interpret mode (Karatsuba, its combinations formed in f64 as the JAX
    engine forms them; at "high" the plain chain takes the same
    combinations, split by ``split_mm_tables``) on a normalized n = 12
    state: one "high" product within HIGH_ORDER_TOL, a chain within the
    rung's bar; and the wrapper takes the plain version for CPU tensors."""
    rng = np.random.default_rng(P)
    R = 32
    v = rng.standard_normal((2, R, 128))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    us = _unitaries(rng, P)
    tables = torch.from_numpy(np.stack([np.stack([u.real, u.imag])
                                        for u in us]).astype(np.float32))
    combos = _karatsuba_combos(us)
    w16 = (KW.split_mm_tables(torch.from_numpy(combos))
           if precision == "high" else None)
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    got = KW.kh0_chain_plain(re, im, tables, precision, w16=w16)
    m = [jnp.asarray(np.ascontiguousarray(combos[:, j])) for j in range(3)]
    call = JW.get_kh0_kernel(R, P, np.float32, precision, True)
    want = call(jnp.asarray(v[0]), jnp.asarray(v[1]), *m)
    bar = HIGH_ORDER_TOL if precision == "high" and P == 1 else tol
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= bar
    KW.reset_launches()
    wrapped = KW.kh0_chain(re, im, tables, precision, w16=w16)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert KW.kh0_chain.launches == {"highest": 0, "high": 0, "default": 0}


@pytest.mark.parametrize("seed", [0, 1])
def test_kh0_chain_plain_high_step_by_step(seed):
    """Each product of the "high" plain chain (P = 8, n = 12) against
    get_kh0_kernel(..., "high") with one matrix in interpret mode on the
    same input, both on the same combinations: within HIGH_ORDER_TOL; the
    schoolbook 3-pass product (four real products) misses that bar."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import mat_high_plain

    rng = np.random.default_rng(200 + seed)
    R, P = 32, 8
    v = rng.standard_normal((2, R, 128))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    us = _unitaries(rng, P)
    tables = torch.from_numpy(np.stack([np.stack([u.real, u.imag])
                                        for u in us]).astype(np.float32))
    combos = _karatsuba_combos(us)
    w16 = KW.split_mm_tables(torch.from_numpy(combos))
    call = JW.get_kh0_kernel(R, 1, np.float32, "high", True)
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    worst = 0.0
    for j in range(P):
        want = call(jnp.asarray(re.numpy()), jnp.asarray(im.numpy()),
                    *(jnp.asarray(combos[j:j + 1, c]) for c in range(3)))
        school = mat_high_plain(re, im, tables[j, 0].T, tables[j, 1].T)
        re, im = KW.kh0_chain_plain(re, im, tables[j:j + 1], "high",
                                    w16=w16[j:j + 1])
        worst = max(worst, *(np.max(np.abs(g.numpy() - np.asarray(w)))
                             for g, w in zip((re, im), want)))
        assert max(np.max(np.abs(g.numpy() - np.asarray(w)))
                   for g, w in zip(school, want)) > HIGH_ORDER_TOL
    assert worst <= HIGH_ORDER_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_kh0_chain_plain_high_is_the_mm_step(seed):
    """kh0_chain_plain at "high" with one product is ``mm_step_high_plain``
    at D = 128 (no row bits) on the same table image, bit for bit: the
    chain's arithmetic is the mm step's, as the kernels share their k-chunk
    body (csrc/karatsuba_high.cuh)."""
    rng = np.random.default_rng(300 + seed)
    v = rng.standard_normal((2, 32, 128))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    us = _unitaries(rng, 1)
    tables = torch.from_numpy(np.stack([np.stack([u.real, u.imag])
                                        for u in us]).astype(np.float32))
    w16 = KW.kh0_high_tables(tables)
    assert w16.shape == (1, 6 * 128 * 128) and w16.dtype == torch.bfloat16
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    got = KW.kh0_chain_plain(re, im, tables, "high")
    want = KW.mm_step_high_plain(re, im, w16[0], ())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the wrapper's tables default to the same image
    again = KW.kh0_chain(re, im, tables, "high", w16=w16)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


# kh0_chain_plain at "highest" computes the JAX kernel's three fp32 products
# on the same fp32 combinations, so only the order inside a 128-term sum
# may differ between torch's and XLA's CPU matmuls (bit-equal on the CPU
# these tests were written on).  1e-8 is ~3 fp32 ulps at the states' peak
# |amp| (~0.044); the four-product (schoolbook) form misses it.
KARATSUBA_TOL = 1e-8


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("P", [1, 8])
def test_kh0_chain_plain_is_the_jax_karatsuba(P, seed):
    """The "highest" plain chain step by step against get_kh0_kernel in
    interpret mode, both given the fp32 tables' own combinations
    (m1 = M_re^T, m2 = (M_im - M_re)^T, m3 = (M_re + M_im)^T), n = 12;
    within KARATSUBA_TOL, which the schoolbook chain misses."""
    rng = np.random.default_rng(100 + seed)
    R = 32
    v = rng.standard_normal((2, R, 128))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    t32 = np.stack([np.stack([u.real, u.imag])
                    for u in _unitaries(rng, P)]).astype(np.float32)
    mr, mi = t32[:, 0], t32[:, 1]
    m = [jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1)))
         for x in (mr, mi - mr, mr + mi)]
    want = JW.get_kh0_kernel(R, P, np.float32, "highest", True)(
        jnp.asarray(v[0]), jnp.asarray(v[1]), *m)
    tables = torch.from_numpy(t32)
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    got = KW.kh0_chain_plain(re, im, tables)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= KARATSUBA_TOL
    for t in tables:
        re, im = re @ t[0].T - im @ t[1].T, re @ t[1].T + im @ t[0].T
    assert max(np.max(np.abs(g.numpy() - np.asarray(w)))
               for g, w in zip((re, im), want)) > KARATSUBA_TOL


# The mxu "high" mm step's geometry per D: (row bits, D), n = 12 (R = 32).
MM_CASES = {128: (), 256: (1,), 512: (0, 2)}


def _mm_inputs(D, seed):
    """A normalized n = 12 state, one random unitary over the lanes and
    the case's row bits, its float32 Karatsuba tables (3, D, D)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((2, 32, 128))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    q, r = np.linalg.qr(rng.standard_normal((D, D))
                        + 1j * rng.standard_normal((D, D)))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    m32 = np.stack([u.real.T, (u.imag - u.real).T,
                    (u.real + u.imag).T]).astype(np.float32)
    return v, m32


# The CPU's sgemm (MKL here) may block a product's k-sum differently for
# different buffers of the same right operand (readings up to 7.5e-9 on
# one 8 x 512 @ 512 x 512 product, amplitudes ~0.02), so two runs of the
# same arithmetic on separately made tables agree to a few ulps; on the
# same table buffers, or on tables made alike (``mm_tables_f32`` of one
# image), they agree bit for bit.
MKL_TOL = 3e-8

# Row-bit patterns of the R = 32 state (5 row bits) for each D.
MM_ROW_BITS = [(128, ()), (256, (0,)), (256, (2,)), (256, (4,)),
               (512, (0, 1)), (512, (0, 4)), (512, (1, 3)), (512, (3, 4))]


def _decode_mm_image(w16, D):
    """``split_mm_tables``' image read back as csrc/mm_high.cu reads it:
    per 32-column block cb and k-chunk c, six parts of 16-byte core
    matrices [kc 2][n 32][8], position p = 8 kc + i of the chunk holding
    k 4 ((p % 8) // 2) + 2 (p // 8) + p % 2.  Returns (6, D, D) float32,
    each part [n][k]."""
    u = w16.view(torch.int16).numpy().view(np.uint16)
    v = (u.astype(np.uint32) << 16).view(np.float32)
    v = v.reshape(D // 32, D // 16, 6, 2, 32, 8)
    out = np.zeros((6, D, D), np.float32)
    for cb in range(D // 32):
        n = cb * 32 + np.arange(32)
        for c in range(D // 16):
            for kc in range(2):
                for i in range(8):
                    p = 8 * kc + i
                    k = 16 * c + 4 * ((p % 8) // 2) + 2 * (p // 8) + p % 2
                    out[:, n, k] = v[cb, c, :, kc, :, i]
    return out


@pytest.mark.parametrize("D", sorted(MM_CASES))
def test_split_mm_tables_image(D):
    """The kernel's table image, read back, is bit for bit the [n][k]
    (hi, lo) bf16 tables the mm step multiplied before the image (the
    split of each Karatsuba table, transposed: the JAX package's mh, ml);
    ``mm_tables_f32`` reads it back as the [k][n] tables, and a leading
    dimension of steps is kept."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import bf16_split

    _, m32 = _mm_inputs(D, D + 1)
    m = torch.from_numpy(m32)
    w16 = KW.split_mm_tables(m)
    assert w16.shape == (6 * D * D,) and w16.dtype == torch.bfloat16
    dense = _decode_mm_image(w16, D)
    hi, lo = bf16_split(m.transpose(-1, -2))
    tabs = KW.mm_tables_f32(w16)
    for c in range(3):
        for j, want in ((2 * c, hi[c]), (2 * c + 1, lo[c])):
            assert np.array_equal(dense[j], want.numpy())
            assert torch.equal(tabs[j].view(torch.int32),
                               want.T.contiguous().view(torch.int32))
    both = KW.split_mm_tables(torch.stack([m, m.flip(-1)]))
    assert both.shape == (2, 6 * D * D) and torch.equal(both[0], w16)
    assert torch.equal(KW.mm_tables_f32(both)[3][1],
                       KW.mm_tables_f32(KW.split_mm_tables(m.flip(-1)))[3])


@pytest.mark.parametrize("D", sorted(MM_CASES))
def test_mm_step_high_plain(D):
    """``mm_step_high_plain`` (what the mm kernel computes, and the CPU
    path of ``_mm_step`` at "high"): its tables are the (hi, lo) bf16
    parts the CPU mm step multiplied before the kernel, bit for bit, and
    on those tables its arithmetic is that step's (``_dot_high``: fp32
    matmuls of bf16-exact parts, then ``t2 += t1; t1 -= t3``) bit for bit;
    within HIGH_TOL of the JAX package's ``_apply_wide_karatsuba`` at
    precision "high" on the CPU; the wrapper takes the plain version for
    CPU tensors and counts no launch, and the engine's step swaps the
    state with its spare pair."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import bf16_split

    row_bits = MM_CASES[D]
    v, m32 = _mm_inputs(D, D)
    R = 32
    fwd, bwd = TW.row_shuffles(row_bits, R)
    xr, xi = fwd(torch.from_numpy(v[0])), fwd(torch.from_numpy(v[1]))
    w16 = KW.split_mm_tables(torch.from_numpy(m32))
    assert w16.shape == (6 * D * D,) and w16.dtype == torch.bfloat16
    tabs = KW.mm_tables_f32(w16)
    hi, lo = bf16_split(torch.from_numpy(m32))
    for c in range(3):
        for got_t, want_t in ((tabs[2 * c], hi[c]), (tabs[2 * c + 1], lo[c])):
            assert torch.equal(got_t.view(torch.int32),
                               want_t.contiguous().view(torch.int32))
    got = KW.karatsuba_high(xr, xi, tabs)

    def dot(x, c):           # the CPU branch of the mm step before the kernel
        xh, xl = bf16_split(x)
        mh, ml = tabs[2 * c], tabs[2 * c + 1]
        return xh @ mh + xl @ mh + xh @ ml

    t1, t2, t3 = dot(xr + xi, 0), dot(xr, 1), dot(xi, 2)
    t2 += t1
    t1 -= t3
    assert torch.equal(got[0], t1) and torch.equal(got[1], t2)

    start = [torch.from_numpy(v[0]), torch.from_numpy(v[1])]
    plain = KW.mm_step_high_plain(*start, w16, row_bits)
    state, spare = list(start), []
    KW.reset_launches()
    TW._mm_step(state, spare, w16, row_bits, R, "high")
    assert KW.mm_step_high.launches == 0
    assert spare[0] is start[0] and spare[1] is start[1]
    for g, p, w in zip(state, plain, (t1, t2)):
        assert g.shape == (R, 128) and torch.equal(g, p)
        assert float((p - bwd(w)).abs().max()) <= MKL_TOL
    want = JW._apply_wide_karatsuba(
        jnp.asarray(v[0]), jnp.asarray(v[1]),
        *(jnp.asarray(m32[c]) for c in range(3)), row_bits, D, R, "high")
    for g, w in zip(state, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= HIGH_TOL
    # a second step writes into the spare pair and swaps back
    first = list(state)
    TW._mm_step(state, spare, w16, row_bits, R, "high")
    assert spare[0] is first[0] and state[0] is start[0]


@pytest.mark.parametrize("D,row_bits", MM_ROW_BITS)
def test_mm_step_high_plain_row_map(D, row_bits):
    """The row-mapped ``mm_step_high_plain`` on the unshuffled (R, 128)
    pair equals the shuffle-based arithmetic (``row_shuffles`` fwd, the
    three split products, ``t2 += t1; t1 -= t3``, bwd) bit for bit, for
    every D and row-bit pattern of an R = 32 state; the wrapper on CPU
    tensors writes the same values into ``out``; and the step is within
    HIGH_TOL of the JAX package's ``_apply_wide_karatsuba(..., "high")``
    on the same row bits."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import bf16_split

    v, m32 = _mm_inputs(D, 7 + len(row_bits) + sum(row_bits))
    R = 32
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    w16 = KW.split_mm_tables(torch.from_numpy(m32))
    tabs = KW.mm_tables_f32(w16)
    got = KW.mm_step_high_plain(re, im, w16, row_bits)
    fwd, bwd = TW.row_shuffles(row_bits, R)
    xr, xi = fwd(re), fwd(im)

    def dot(x, c):
        xh, xl = bf16_split(x)
        return xh @ tabs[2 * c] + xl @ tabs[2 * c] + xh @ tabs[2 * c + 1]

    t1, t2, t3 = dot(xr + xi, 0), dot(xr, 1), dot(xi, 2)
    t2 += t1
    t1 -= t3
    assert torch.equal(got[0], bwd(t1)) and torch.equal(got[1], bwd(t2))
    out = (torch.empty_like(re), torch.empty_like(im))
    res = KW.mm_step_high(re, im, w16, row_bits, out=out)
    assert res is out and torch.equal(out[0], got[0]) \
        and torch.equal(out[1], got[1])
    want = JW._apply_wide_karatsuba(
        jnp.asarray(v[0]), jnp.asarray(v[1]),
        *(jnp.asarray(m32[c]) for c in range(3)), row_bits, D, R, "high")
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= HIGH_TOL


def test_mm_step_high_refuses():
    """The wrapper refuses other devices, dtypes, shapes and row bits; the
    wide program, which owns the mm step, refuses a rung that is not one
    ("default" runs: tests/test_torch_default.py)."""
    v, m32 = _mm_inputs(256, 1)
    x = torch.from_numpy(v[0])
    w16 = KW.split_mm_tables(torch.from_numpy(m32))
    meta = torch.zeros(32, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KW.mm_step_high(meta, meta, w16.to("meta"), (1,))
    with pytest.raises(ValueError, match="float32"):
        KW.mm_step_high(x.double(), x.double(), w16, (1,))
    with pytest.raises(ValueError, match="bfloat16"):
        KW.mm_step_high(x, x, w16.float(), (1,))
    with pytest.raises(ValueError, match="bfloat16"):
        KW.mm_step_high(x, x, w16[:3], (1,))
    with pytest.raises(ValueError, match="bfloat16"):
        KW.mm_step_high(x, x, w16, (0, 1))
    with pytest.raises(ValueError, match=r"\(R, 128\)"):
        KW.mm_step_high(x[:, :64], x[:, :64], w16, (1,))
    with pytest.raises(ValueError, match=r"\(R, 128\)"):
        KW.mm_step_high(x, x[:8], w16, (1,))
    for bits in ((5,), (1, 1), (2, 1), (0, 1, 2), (-1,)):
        with pytest.raises(ValueError, match="row_bits"):
            KW.mm_step_high(x, x, w16, bits)
    ops = TS._fuse_pipeline(mixed(T.Circuit, 10), 7, max_high=2, window=8)
    with pytest.raises(ValueError, match="rungs"):
        TW.WideProgram(ops, 10, precision="bogus", device="cpu")


def test_mm_step_high_refuses_aliased_out():
    """The kernel is not in place: an ``out`` pair that is, or overlaps,
    the input pair (or itself) is refused on every device, before any
    work; a distinct pair is taken."""
    v, m32 = _mm_inputs(512, 2)
    re, im = torch.from_numpy(v[0]).clone(), torch.from_numpy(v[1]).clone()
    w16 = KW.split_mm_tables(torch.from_numpy(m32))
    buf = torch.empty(3, 32, 128)
    for out in ((re, torch.empty_like(im)), (torch.empty_like(re), im),
                (im, re), (buf[0], buf[0]),
                (torch.empty_like(re), im.view(-1)[:4096].view(32, 128))):
        with pytest.raises(ValueError, match="alias"):
            KW.mm_step_high(re, im, w16, (0, 3), out=out)
    assert torch.equal(re, torch.from_numpy(v[0]))
    out = (buf[1], buf[2])
    got = KW.mm_step_high(re, im, w16, (0, 3), out=out)
    assert got is out and torch.equal(
        out[1], KW.mm_step_high_plain(re, im, w16, (0, 3))[1])


def test_kh0_chain_writes_into_out_and_rejects_default():
    rng = np.random.default_rng(3)
    re, im = (torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
              for _ in range(2))
    tables = torch.from_numpy(np.stack([np.stack([u.real, u.imag]) for u in
                                        _unitaries(rng, 2)]).astype(np.float32))
    want = KW.kh0_chain_plain(re, im, tables)
    out = (re.clone(), im.clone())
    got = KW.kh0_chain(*out, tables, out=out)
    assert got[0] is out[0] and torch.equal(got[0], want[0])
    # "default" runs (its one pass, tests/test_torch_default.py); a rung
    # that is not one is refused
    got = KW.kh0_chain(re, im, tables, "default")
    assert all(torch.equal(g, w) for g, w in zip(
        got, KW.kh0_chain_plain(re, im, tables, "default")))
    with pytest.raises(ValueError, match="rungs"):
        KW.kh0_chain(re, im, tables, "bogus")


def test_wrappers_refuse_other_devices():
    re = torch.zeros(8, 128, device="meta")
    tables = torch.zeros(1, 2, 128, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        KW.kh0_chain(re, re, tables)
    with pytest.raises(ValueError, match="unsupported device"):
        KW.apply_block128(re, re, tables[0, 0], tables[0, 1])


def _mxu(**kw):
    return T.Simulator(T.SimulatorConfig(strategy="mxu", **kw), device="cpu")


def _jmxu(**kw):
    return JS.Simulator(JConfig(strategy="mxu", **kw))


@pytest.mark.parametrize("case", ["grover", "low_only_k3"])
def test_mxu_amplitudes_match_jax(case):
    """Simulator(strategy="mxu") of both packages at "highest": the port's
    kh0 runs (P = 8 chains on the low-only circuit) through the plain chain,
    the JAX package's through XLA matmuls."""
    if case == "grover":
        tc, jc, kw = (T.models.grover_like(10, 300, 9),
                      JM.grover_like(10, 300, 9), {})
    else:
        tc, jc, kw = (low_only(T.Circuit, 10, 600),
                      low_only(JCircuit, 10, 600), {"max_fused_qubits": 3})
    TS._MXU_PLAN_CACHE.clear()
    got = _mxu(precision="highest", **kw).run_detailed(tc)
    want = _jmxu(precision="highest", **kw).run_detailed(jc)
    assert got.num_fused_ops == want.num_fused_ops
    assert got.state.dtype == np.complex64
    assert np.max(np.abs(got.state - np.asarray(want.state))) <= AMP_TOL
    if case == "low_only_k3":
        (_, prog), = TS._MXU_PLAN_CACHE.values()
        runs = [st[2] for seg in prog.segments for st in seg.steps]
        assert runs == [8] * 9


@pytest.mark.parametrize("case", ["grover", "low_only_k3"])
def test_mxu_high_rung_against_highest(case):
    """"high" is a different product (strictly above 0) within the rung's
    bar of the port's own "highest" run (scaled to the state's peak
    amplitude, ``high_tol``)."""
    if case == "grover":
        c, kw = T.models.grover_like(12, 600, 41), {}
    else:
        c, kw = low_only(T.Circuit, 10, 600), {"max_fused_qubits": 3}
    hi = _mxu(precision="high", **kw).run(c)
    ref = _mxu(precision="highest", **kw).run(c)
    err = float(np.max(np.abs(hi - ref)))
    assert 0.0 < err <= high_tol(ref), err


def test_mxu_is_the_default():
    c = T.models.ghz(10)
    res = T.Simulator(device="cpu").run_detailed(c)
    assert res.strategy == "mxu"
    assert abs(res.state[0] - 2 ** -0.5) < AMP_TOL
    assert abs(T.simulate(c, device="cpu")[-1] - 2 ** -0.5) < AMP_TOL
    assert T.SimulatorConfig().effective_precision(24) == "high"


def test_mxu_initial_state_resume():
    """A prefix then a resumed suffix equals the whole circuit (the initial
    state is mapped into the relabeled basis)."""
    n = 10
    full = T.models.grover_like(n, 200, 31)
    first, second = T.Circuit(n), T.Circuit(n)
    first.gates = full.gates[:100]
    second.gates = full.gates[100:]
    sim = _mxu(precision="highest")
    got = sim.run(second, initial=sim.run(first))
    want = np.asarray(_jmxu(precision="highest").run(JM.grover_like(n, 200, 31)))
    assert np.max(np.abs(got - want)) <= 2 * AMP_TOL


def test_mxu_plan_cache_skips_refusion(monkeypatch):
    c = T.models.grover_like(9, 120, 77)
    first = _mxu().run(c)

    def boom(*a, **k):
        raise AssertionError("plan cache missed: circuit was re-fused")

    monkeypatch.setattr(TS, "_fuse_pipeline", boom)
    assert np.array_equal(_mxu().run(c), first)
    c.h(0)
    with pytest.raises(AssertionError, match="re-fused"):
        _mxu().run(c)


@pytest.mark.parametrize("n", [12, 16])
def test_unpermute_device_matches_jax(n):
    """n = 12: the dense (2,)*n transpose; n = 16: bit transpositions."""
    rng = np.random.default_rng(n)
    perm = rng.permutation(n)
    v = rng.standard_normal((2, 1 << n)).astype(np.float32)
    got = TA.unpermute_device(torch.from_numpy(v[0]), torch.from_numpy(v[1]),
                              [int(p) for p in perm])
    want = JA.unpermute_device(jnp.asarray(v[0]), jnp.asarray(v[1]),
                               tuple(int(p) for p in perm))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("strategy", ["prefetch", "mxu"])
def test_permute_true_matches_permute_false(strategy):
    c = T.models.grover_like(11, 300, 3)
    a = T.Simulator(T.SimulatorConfig(strategy=strategy, permute=True),
                    device="cpu").run(c)
    b = T.Simulator(T.SimulatorConfig(strategy=strategy), device="cpu").run(c)
    assert np.max(np.abs(a - b)) <= AMP_TOL


@pytest.mark.parametrize("kind,exc", [
    ("n7", None), ("n31", ValueError), ("default", None), ("complex128", None),
])
def test_mxu_faults_raise(kind, exc):
    # Only n > 30 still raises, before anything is planned or built.  The
    # former fences run now: complex128 on the megakernel arm of n = 7 and
    # on the wide engine (float64 throughout), and the "default" rung (one
    # bf16 pass: its error lies above 1e-6, within the Karatsuba bar of
    # tests/test_torch_default.py)
    n = {"n7": 7, "n31": 31}.get(kind, 10)
    kw = {"default": dict(precision="default"),
          "complex128": dict(dtype="complex128"),
          "n7": dict(dtype="complex128")}.get(kind, {})
    c = T.Circuit(n)
    c.h(0)
    TS._MXU_PLAN_CACHE.clear()
    if exc is not None:
        with pytest.raises(exc, match="ceiling"):
            _mxu(**kw).run(c)
        assert not TS._MXU_PLAN_CACHE    # nothing was planned or built
        return
    c = T.models.grover_like(n, 300, 9)
    got = _mxu(**kw).run(c)
    err = float(np.max(np.abs(got - simulate_reference(c))))
    if kind == "default":
        assert 1e-6 < err <= 2e-3 * max(1.0, float(np.max(np.abs(got)))
                                        / HIGH_BAR_PEAK)
    else:
        assert got.dtype == np.complex128 and err <= 1e-9
