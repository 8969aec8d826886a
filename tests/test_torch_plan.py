"""The port's JAX-free host modules plan exactly like the JAX package.

Both packages generate, relabel, fuse (through the same native fuser),
plan and pack the benchmark circuit ``grover_like(n, 2445, 318)``; the
fused ops, the plan's blocks and every ``materialize_entries`` array must
agree.  n=18 and n=22 are the widths the port's main path runs (planning
only here); n=12 with a 4-row tile and 1-row relayout blocks makes a small
plan with both steered prologues and relayout entries.  From n = 23 both
packages plan with the portfolio (``plan_prefetch_best`` over the plan cost
model) and fold relayouts into the next block (scal mode 5): n = 23, 24,
26 and 28 hold those plans, tables and cost estimates to the JAX package.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import plancost as JPC
from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu.engine.simulator import _fuse_pipeline as j_fuse
from gpu_quantum_simulator_tpu.passes.permute import plan_permutation as j_perm

from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.config import SimulatorConfig as TConfig
from gpu_quantum_simulator_tpu_torch.engine import plancost as TPC
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline as t_fuse
from gpu_quantum_simulator_tpu_torch.passes.permute import plan_permutation as t_perm

MAT_TOL = 1e-12   # both packages call one native fuser: only f64 noise


@pytest.fixture
def tiles(monkeypatch):
    """Set (TILE_ROWS, RELAYOUT_TILE_ROWS) in both packages, caches cleared."""
    def set_tiles(t, tr):
        for pf in (JPF, TPF):
            monkeypatch.setattr(pf, "TILE_ROWS", t)
            monkeypatch.setattr(pf, "RELAYOUT_TILE_ROWS", tr)
        for cache in (JPF._KERNEL_CACHE, JPF._CHAIN_CACHE, JPF._PROGRAM_CACHE,
                      JPF._RUN_CACHE, TPF._PROGRAM_CACHE, TPF._RUN_CACHE):
            cache.clear()

    yield set_tiles
    for cache in (JPF._KERNEL_CACHE, JPF._CHAIN_CACHE, JPF._PROGRAM_CACHE,
                  JPF._RUN_CACHE, TPF._PROGRAM_CACHE, TPF._RUN_CACHE):
        cache.clear()


def _plan(models, config, pf, fuse, plan_permutation, n, planner=None,
          gates=2445):
    """Fuse and plan the benchmark circuit as the engine does; ``planner``
    defaults to ``pf.plan_prefetch``, and from n = 23 the relayouts fold."""
    c = models.grover_like(n, gates, 318)
    perm = plan_permutation(c)
    max_high, cap_mats, window = pf.resolve_prefetch_knobs(
        config(strategy="prefetch"), n, False)
    ops = fuse(c.relabeled(perm), 7, max_high=max_high, window=window)
    plan = (planner or pf.plan_prefetch)(ops, n, cap_mats=cap_mats,
                                         final_layout=np.argsort(perm))
    R2 = 1 << (n - pf.LOCAL_QUBITS)
    max_chunk = max(32, pf.DISPATCH_GRID_BUDGET // max(R2 // pf.tile_rows(n), 1))
    entries = pf.materialize_entries(
        plan.blocks, pf.CAP_STEPS, cap_mats, np.float32,
        single_class=cap_mats <= 4, max_chunk=max_chunk,
        fold_relayout=pf.resolve_stream_relayout(n, False),
        mono_as_mat=plan.mono_as_mat)
    return c, ops, plan, entries


def _assert_same_plans(jplan, tplan, jent, tent):
    assert len(jplan.blocks) == len(tplan.blocks)
    for a, b in zip(jplan.blocks, tplan.blocks):
        assert (a.kinds, a.midx, a.prologue) == (b.kinds, b.midx, b.prologue)
        assert (a.relayout is None) == (b.relayout is None)
        if a.relayout is not None:
            assert np.array_equal(a.relayout, b.relayout)
    assert np.array_equal(jplan.final_position, tplan.final_position)
    assert (jplan.num_tswaps, jplan.num_xswaps, jplan.num_perms,
            jplan.num_relayouts, jplan.mono_as_mat) == \
        (tplan.num_tswaps, tplan.num_xswaps, tplan.num_perms,
         tplan.num_relayouts, tplan.mono_as_mat)

    assert len(jent) == len(tent)
    for ja, ta in zip(jent, tent):
        assert ja[0] == ta[0] and ja[1] == ta[1]      # capacity, chunk sizes
        for x, y in zip(ja[2:], ta[2:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n,t,tr", [(18, 512, 64), (22, 512, 64), (12, 4, 1)])
def test_port_plans_like_jax(tiles, n, t, tr):
    tiles(t, tr)
    jc, jops, jplan, jent = _plan(JM, JConfig, JPF, j_fuse, j_perm, n)
    tc, tops, tplan, tent = _plan(TM, TConfig, TPF, t_fuse, t_perm, n)

    assert [(g.name, g.qubits, g.params) for g in jc.gates] == \
        [(g.name, g.qubits, g.params) for g in tc.gates]
    assert len(jops) == len(tops)
    for a, b in zip(jops, tops):
        assert (a.kind, a.qubits) == (b.kind, b.qubits)
        assert np.max(np.abs(a.u - b.u)) <= MAT_TOL
    _assert_same_plans(jplan, tplan, jent, tent)

    # the widths exercise what the slice must run
    assert any(b.prologue is not None for b in tplan.blocks)
    if n == 18:
        assert tplan.num_relayouts == 0 and not tplan.mono_as_mat
    else:
        assert tplan.num_relayouts > 0


@pytest.mark.parametrize("arm", [None, False, True])
def test_profiling_plan_counts(tiles, monkeypatch, arm):
    """The profiling tool's plan counts add up under each mono arm."""
    from gpu_quantum_simulator_tpu_torch import profiling

    tiles(4, 1)
    monkeypatch.setattr(TPF, "MONO_AS_MAT", arm)
    got = profiling.plan_counts(12)
    assert got["mono_as_mat"] == (arm is True)
    assert got["mat_steps"] + got["mono_steps"] == got["fused_ops"]
    assert got["mono_steps"] == (0 if arm else got["monomial_ops"])
    assert got["relayouts"] > 0 and got["steered"] > 0


def test_knobs_ignore_environment(monkeypatch):
    """The port's plan knobs come from the config and the defaults only."""
    for var, value in (("QSIM_PREFETCH_MAX_HIGH", "1"),
                       ("QSIM_PREFETCH_CAP_MATS", "3"),
                       ("QSIM_FUSION_WINDOW", "4")):
        monkeypatch.setenv(var, value)
    assert TPF.resolve_prefetch_knobs(TConfig(strategy="prefetch"), 18,
                                      False) == (2, TPF.CAP_MATS, 8)
    assert TPF.resolve_prefetch_knobs(TConfig(strategy="prefetch"), 22,
                                      False) == (2, 8, 16)


def test_host_build_dir_is_keyed_by_flags(monkeypatch):
    """Host libraries built for one CPU target are never reused on another."""
    import platform

    from gpu_quantum_simulator_tpu_torch.ref import native

    monkeypatch.setattr(native, "_build_dir", None)
    first = native.host_build_dir()
    assert first.startswith(native.HOST_BUILD_ROOT)
    assert platform.machine() in first
    monkeypatch.setattr(native, "_build_dir", None)
    monkeypatch.setattr(native, "HOST_CXXFLAGS", native.HOST_CXXFLAGS + ["-g"])
    assert native.host_build_dir() != first


@pytest.mark.parametrize("n", [23, 24, 26, 28])
def test_portfolio_and_fold_plan_like_jax(n):
    """The n >= 23 path: the portfolio's choice, the folded (mode 5) rows
    with their sigma slots, and every table equal the JAX package's; the
    port's PrefetchProgram planner (``plan_circuit``) is the portfolio."""
    assert TPF.PLAN_PORTFOLIO == JPF.PLAN_PORTFOLIO
    assert TPF.PORTFOLIO_MIN_QUBITS == JPF.PORTFOLIO_MIN_QUBITS
    jc, jops, jplan, jent = _plan(JM, JConfig, JPF, j_fuse, j_perm, n,
                                  JPF.plan_prefetch_best)
    tc, tops, tplan, tent = _plan(TM, TConfig, TPF, t_fuse, t_perm, n,
                                  TPF.plan_circuit)
    _assert_same_plans(jplan, tplan, jent, tent)

    rows = np.concatenate([e[2] for e in tent])
    soff = 4 + 2 * TPF.CAP_STEPS
    folded = rows[rows[:, 1] == 5]
    mrow = n - TPF.LOCAL_QUBITS - int(np.log2(TPF.relayout_rows(n)))
    assert len(folded) > 0 and (rows[:, 1] == 3).sum() < tplan.num_relayouts
    assert len(folded) + (rows[:, 1] == 3).sum() == tplan.num_relayouts
    for row in folded:                  # sigma: a permutation of the bits
        assert sorted(row[soff : soff + mrow]) == list(range(mrow))
        assert not row[soff + mrow :].any() and row[0] > 0


@pytest.mark.parametrize("n", [23, 24, 26, 28])
def test_plancost_estimates_like_jax(n):
    """Per portfolio depth, fold on and off: the port's cost model prices
    the port's plan as the JAX model prices the JAX plan."""
    for name in ("BASE_STEERED", "BASE_PLAIN", "BASE_SPLIT", "MAT", "PERM",
                 "MONO", "RELAYOUT", "FOLD_IN", "XSWAP_SPLIT", "DISPATCH_S"):
        assert getattr(TPC, name) == getattr(JPC, name), name
    assert [TPC.tswap_us(k) for k in range(1, 10)] == \
        [JPC.tswap_us(k) for k in range(1, 10)]
    jc = JM.grover_like(n, 2445, 318)
    tc = TM.grover_like(n, 2445, 318)
    knobs = TPF.resolve_prefetch_knobs(TConfig(strategy="prefetch"), n, False)
    jperm, tperm = j_perm(jc), t_perm(tc)
    jops = j_fuse(jc.relabeled(jperm), 7, max_high=knobs[0], window=knobs[2])
    tops = t_fuse(tc.relabeled(tperm), 7, max_high=knobs[0], window=knobs[2])
    for waves in TPF.PLAN_PORTFOLIO:
        jplan = JPF.plan_prefetch(jops, n, cap_mats=knobs[1],
                                  final_layout=np.argsort(jperm),
                                  lookahead_waves=waves)
        tplan = TPF.plan_prefetch(tops, n, cap_mats=knobs[1],
                                  final_layout=np.argsort(tperm),
                                  lookahead_waves=waves)
        for fold in (False, True):
            want, wacc = JPC.estimate_plan(jplan, n, fold_relayout=fold)
            got, gacc = TPC.estimate_plan(tplan, n, fold_relayout=fold)
            assert abs(got - want) <= 1e-12 * abs(want), (waves, fold)
            assert gacc["dispatch_parts"] == wacc["dispatch_parts"]


def test_resolve_stream_relayout_refuses_inplace():
    """The fold is for flat plans from n = 23 only; an in-place plan never
    folds, at any width (the JAX package's forced fold corrupted in-place
    amplitudes: ROADMAP queue C)."""
    assert TPF.STREAM_RELAYOUT_MIN_QUBITS == JPF.STREAM_RELAYOUT_MIN_QUBITS
    for n in range(TPF.MIN_QUBITS, TPF.MAX_QUBITS + 1):
        assert TPF.resolve_stream_relayout(n, inplace=True) is False
        assert TPF.resolve_stream_relayout(n, False) is (n >= 23)
        assert TPF.resolve_stream_relayout(n) == JPF.resolve_stream_relayout(n)


@pytest.mark.parametrize("n,inplace", [(12, False), (12, True), (23, False)])
def test_plans_do_not_depend_on_the_rung(tiles, n, inplace):
    """The prefetch engine's program is planned alike at every rung, as in
    the JAX package (whose planner takes no rung): flat (n = 12 with a
    4-row tile), in place, and the portfolio with folded relayouts (n = 23,
    a 300-gate prefix of the benchmark family).  Each rung's chain holds
    the same scal rows and tables, and the flat ones are the JAX
    package's."""
    if n == 12:
        tiles(4, 1)
    jc, jops, jplan, jent = _plan(JM, JConfig, JPF, j_fuse, j_perm, n,
                                  JPF.plan_prefetch_best, gates=300)
    tc, tops, tplan, tent = _plan(TM, TConfig, TPF, t_fuse, t_perm, n,
                                  TPF.plan_circuit, gates=300)
    _, cap_mats, _ = TPF.resolve_prefetch_knobs(
        TConfig(strategy="prefetch"), n, inplace)
    chains = {}
    for rung in ("highest", "high", "default"):
        prog = TPF.PrefetchProgram(
            tops, n, precision=rung, cap_mats=cap_mats,
            final_layout=np.argsort(t_perm(tc)), device="cpu",
            inplace=inplace)
        chains[rung] = prog._chain._parts
    for rung in ("high", "default"):
        assert len(chains[rung]) == len(chains["highest"])
        for a, b in zip(chains[rung], chains["highest"]):
            assert a[0] == b[0]                          # scal rows
            # in place the host factors, flat the expanded device tables
            for u, w in zip(*((a[1], b[1]) if inplace else (a[1:4], b[1:4]))):
                assert np.array_equal(np.asarray(u), np.asarray(w))
    if not inplace:
        rows = [r for part in chains["default"] for r in part[0]]
        want = np.concatenate([e[2] for e in jent]).tolist()
        assert rows == want
