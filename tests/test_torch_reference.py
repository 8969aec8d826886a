"""The port's facade repairs held to the JAX package: ``strategy="reference"``
(the numpy complex128 simulator of ref/cpu.py, on the host) and
``SimulatorConfig.fusion_cost_model`` (the mxu engine's fusion switch)."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import simulator as JS
from gpu_quantum_simulator_tpu.ref import cpu as JR

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import simulator as TS
from gpu_quantum_simulator_tpu_torch.passes.permute import plan_permutation
from gpu_quantum_simulator_tpu_torch.ref import cpu as TR

MAT_TOL = 1e-12      # fused matrices: the same f64 products, another build
AMP_TOL = 1e-6       # "highest" amplitudes (BASELINE.md bar)


def _ref(device="cpu"):
    return T.Simulator(T.SimulatorConfig(strategy="reference"), device=device)


def test_reference_strategy_matches_jax_exactly():
    """``run_detailed`` returns the JAX package's RunResult fields and the
    same complex128 amplitudes, bit for bit, on the benchmark family."""
    got = _ref().run_detailed(T.models.grover_like(10, 200, 318))
    want = JS.Simulator(JConfig(strategy="reference")).run_detailed(
        JM.grover_like(10, 200, 318))
    assert got.state.dtype == np.complex128
    assert np.array_equal(got.state, want.state)
    for field in ("num_qubits", "num_gates", "num_fused_ops", "strategy"):
        assert getattr(got, field) == getattr(want, field)
    assert got.num_fused_ops == got.num_gates == 200


def test_reference_resumes_from_initial_and_samples_on_host():
    rng = np.random.default_rng(3)
    v = rng.standard_normal(1 << 9) + 1j * rng.standard_normal(1 << 9)
    v /= np.linalg.norm(v)
    tc, jc = T.models.grover_like(9, 120, 4), JM.grover_like(9, 120, 4)
    assert np.array_equal(_ref().run(tc, initial=v),
                          JR.simulate_reference(jc, initial=v))
    assert np.array_equal(TR.simulate_reference(tc, dtype=np.complex64),
                          JR.simulate_reference(jc, dtype=np.complex64))
    assert np.array_equal(TR.initial_state(5), JR.initial_state(5))
    for g_t, g_j in zip(tc.gates[:20], jc.gates[:20]):
        assert np.array_equal(TR.apply_gate_numpy(v, 9, g_t),
                              JR.apply_gate_numpy(v, 9, g_j))
    assert np.array_equal(
        _ref().sample(tc, 500, seed=7),
        JS.Simulator(JConfig(strategy="reference")).sample(jc, 500, seed=7))
    with pytest.raises(ValueError, match="wrong length"):
        _ref().run(tc, initial=v[:-1])


def test_reference_wide_sample_stays_on_host(monkeypatch):
    """Above n = 22 the reference still samples its host vector, as the JAX
    package does: neither device sampler nor engine runs."""
    from gpu_quantum_simulator_tpu_torch import sampling as TSM

    v = np.zeros(1 << 4, complex)
    v[5] = 1.0
    monkeypatch.setattr(TR, "simulate_reference", lambda c, initial=None: v)
    for name in ("sample_halves", "sample_state_device"):
        monkeypatch.setattr(TSM, name, lambda *a: pytest.fail("device"))
    monkeypatch.setattr(TS.Simulator, "run_device",
                        lambda *a, **k: pytest.fail("device run"))
    assert set(_ref().sample(T.Circuit(23), 50).tolist()) == {5}


def test_reference_has_no_device_state():
    c = T.models.grover_like(8, 30, 1)
    with pytest.raises(ValueError, match="runs on the host"):
        _ref().run_device(c)
    with pytest.raises(ValueError, match="run_device_halves requires"):
        _ref().run_device_halves(c)


@pytest.mark.parametrize("cost_model", [False, True, None])
def test_fusion_cost_model_matches_jax(cost_model):
    """``fusion_cost_model`` reaches the mxu arm's fusion as in the JAX
    package (None means on): the same ops, op for op, as the JAX package's
    ``_fuse_pipeline(..., cost_model=...)``, the same amplitudes, and a plan
    cache entry of its own."""
    n = 10
    tc, jc = T.models.grover_like(n, 300, 9), JM.grover_like(n, 300, 9)
    TS._MXU_PLAN_CACHE.clear()
    cfg = dict(strategy="mxu", precision="highest",
               fusion_cost_model=cost_model)
    got = T.Simulator(T.SimulatorConfig(**cfg), device="cpu").run_detailed(tc)
    want = JS.Simulator(JConfig(**cfg)).run_detailed(jc)
    (ops, _), = TS._MXU_PLAN_CACHE.values()
    jops = JS._fuse_pipeline(jc.relabeled(plan_permutation(jc)), 7,
                             max_high=2, window=8,
                             cost_model=cost_model is not False)
    assert len(ops) == len(jops) == got.num_fused_ops == want.num_fused_ops
    for a, b in zip(ops, jops):
        assert a.kind == b.kind and tuple(a.qubits) == tuple(b.qubits)
        assert np.max(np.abs(np.asarray(a.u) - np.asarray(b.u))) <= MAT_TOL
    assert np.max(np.abs(got.state - np.asarray(want.state))) <= AMP_TOL
    other = T.SimulatorConfig(**dict(cfg, fusion_cost_model=not cost_model))
    T.Simulator(other, device="cpu").run(tc)
    assert len(TS._MXU_PLAN_CACHE) == (1 if cost_model is None else 2)
    TS._MXU_PLAN_CACHE.clear()


def test_fusion_cost_model_changes_the_fusion():
    """On the benchmark family the switch matters: without the cost model
    the fusion packs other blocks."""
    c = T.models.grover_like(12, 600, 318)
    c = c.relabeled(plan_permutation(c))
    on = TS._fuse_pipeline(c, 7, max_high=2, window=8, cost_model=True)
    off = TS._fuse_pipeline(c, 7, max_high=2, window=8, cost_model=False)
    assert [op.qubits for op in on] != [op.qubits for op in off]
