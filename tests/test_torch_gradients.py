"""The port's ``gradients.py`` against the JAX package's, on the CPU.

The same circuits (each package's own ``models``, same arguments) go
through each package's function.  Bars: 1e-5 for gradients, values and
landscapes (float32 sums in another order); ``run_vqe``'s energies and
thetas against optax's adam at 1e-4 over 20 steps, restarts included
(float32 rounding accumulates over the steps); the host parts (gate
discovery, ``theta0``, ``idxs``) and the validation errors are exact.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import gradients as JG
from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig

import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import gradients as TG
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.config import SimulatorConfig as TConfig

TOL = 1e-5
VQE_TOL = 1e-4


def _both(build):
    """(JAX circuit, port circuit) from one builder over ``models``."""
    return build(JM), build(TM)


def _vqe_circuit(M, n=4, seed=0):
    rng = np.random.default_rng(seed)
    c = M.random_circuit(n, 0, seed=0)          # an empty n-qubit circuit
    for q in range(n):
        c.append("h", q)
    for _ in range(2):
        for q in range(n):
            c.append("rz", q, params=(float(rng.uniform(-np.pi, np.pi)),))
            c.append("ry", q, params=(float(rng.uniform(-np.pi, np.pi)),))
        for q in range(n - 1):
            c.append("cx", q, q + 1)
    return c


def _tfim(M, n=4, seed=3):
    rng = np.random.default_rng(seed)
    c = M.random_circuit(n, 0, seed=0)
    for q in range(n):
        c.ry(rng.uniform(-0.4, 0.4), q)
    for q in range(n - 1):
        c.cx(q, q + 1)
    for q in range(n):
        c.ry(rng.uniform(-0.4, 0.4), q)
    terms = [(-1.0, f"Z{i} Z{i + 1}") for i in range(n - 1)]
    terms += [(-0.7, f"X{i}") for i in range(n)]
    return c, terms


def _same_error(call):
    with pytest.raises(ValueError) as got:
        call(TG, TM)
    with pytest.raises(ValueError) as want:
        call(JG, JM)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ host parts
def test_parameterized_gates_and_shift_match_jax():
    jc, tc = _both(lambda M: M.random_circuit(6, 50, seed=2))
    assert TG.parameterized_gates(tc) == JG.parameterized_gates(jc)
    i = TG.parameterized_gates(tc)[0]
    assert ([(g.name, g.qubits, g.params)
             for g in TG._shifted(tc, i, 0.25).gates]
            == [(g.name, g.qubits, g.params)
                for g in JG._shifted(jc, i, 0.25).gates])


@pytest.mark.parametrize("strategy", ["reference", "mxu", "prefetch"])
def test_parameter_shift_matches_jax(strategy):
    jc, tc = _vqe_circuit(JM, n=9 if strategy == "prefetch" else 4), \
        _vqe_circuit(TM, n=9 if strategy == "prefetch" else 4)
    idxs = JG.parameterized_gates(jc)[:4]
    want, wi = JG.parameter_shift(jc, [0, 1], JConfig(strategy=strategy),
                                  gate_indices=idxs)
    got, gi = TG.parameter_shift(tc, [0, 1], TConfig(strategy=strategy),
                                 gate_indices=idxs, device="cpu")
    assert gi == wi
    np.testing.assert_allclose(got, want, atol=TOL)


def test_parameter_shift_with_expectation_fn_matches_jax():
    import gpu_quantum_simulator_tpu as J

    terms = [(0.7, "Z0 Z1"), (-0.3, "X0"), (0.2, "Y2 Z0"), (0.5, "IIII")]
    jc, tc = _both(lambda M: M.random_circuit(4, 30, seed=13))
    want, _ = JG.parameter_shift(
        jc, expectation_fn=lambda c: J.expectation_pauli_sum(c, terms))
    got, _ = TG.parameter_shift(
        tc, expectation_fn=lambda c: T.expectation_pauli_sum(
            c, terms, device="cpu"), device="cpu")
    np.testing.assert_allclose(got, want, atol=TOL)


def test_parameter_shift_noisy_zero_noise_matches_jax():
    jc, tc = _both(lambda M: M.random_circuit(2, 12, seed=4))
    want, wi = JG.parameter_shift_noisy(jc, [(1.0, "Z0 Z1")], shots=8)
    got, gi = TG.parameter_shift_noisy(tc, [(1.0, "Z0 Z1")], shots=8,
                                       device="cpu")
    assert gi == wi
    np.testing.assert_allclose(got, want, atol=TOL)


# --------------------------------------------------------------- adjoint
@pytest.mark.parametrize("n,gates,seed,strategy", [
    (5, 40, 11, "mxu"), (9, 60, 3, "mxu"), (9, 60, 5, "prefetch"),
    (4, 30, 13, "megakernel")])
def test_adjoint_gradient_matches_jax(n, gates, seed, strategy):
    terms = [(0.7, "Z0 Z1"), (-0.3, "X0"), (0.2, "Y2 Z0"), (0.5, "I0")]
    jc, tc = _both(lambda M: M.random_circuit(n, gates, seed=seed))
    want, wi = JG.adjoint_gradient(jc, terms=terms,
                                   config=JConfig(strategy=strategy))
    got, gi = TG.adjoint_gradient(tc, terms=terms,
                                  config=TConfig(strategy=strategy),
                                  device="cpu")
    assert gi == wi and len(gi) > 0
    np.testing.assert_allclose(got, want, atol=TOL)


def test_adjoint_all_rotation_kinds_and_z_string():
    def build(M):
        c = M.random_circuit(2, 0, seed=0)
        c.h(0)
        c.rx(0.3, 0)
        c.ry(-0.8, 1)
        c.cx(0, 1)
        c.rz(0.5, 1)
        c.p(1.1, 0)
        return c

    jc, tc = _both(build)
    want, _ = JG.adjoint_gradient(jc, z_qubits=[0, 1])
    got, idxs = TG.adjoint_gradient(tc, z_qubits=[0, 1], device="cpu")
    assert len(idxs) == 4
    np.testing.assert_allclose(got, want, atol=TOL)
    shift, _ = TG.parameter_shift(tc, z_qubits=[0, 1], device="cpu")
    np.testing.assert_allclose(got, shift, atol=2e-6)


def test_adjoint_rejects_unsupported_gate_index():
    def call(G, M):
        c = M.random_circuit(1, 0, seed=0)
        c.h(0)
        kw = {"device": "cpu"} if G is TG else {}
        G.adjoint_gradient(c, z_qubits=[0], gate_indices=[0], **kw)

    _same_error(call)


# ------------------------------------------------------- value and grad
def test_value_and_grad_matches_jax_and_adjoint():
    jc, terms = _tfim(JM, seed=5)
    tc, _ = _tfim(TM, seed=5)
    jc.u(0.3, 0.1, -0.2, 0)             # a fixed gate with parameters
    tc.u(0.3, 0.1, -0.2, 0)
    jf, ji, jt = JG.make_adjoint_value_and_grad(jc, terms)
    tf, ti, tt = TG.make_adjoint_value_and_grad(tc, terms, device="cpu")
    assert ti == ji and np.array_equal(tt, jt)
    je, jg = jf(jt)
    te, tg = tf(tt)
    assert te.dim() == 0 and tg.dim() == 1 and tg.dtype == torch.float32
    assert abs(float(te) - float(je)) < TOL
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    adj, _ = TG.adjoint_gradient(tc, terms=terms, device="cpu")
    np.testing.assert_allclose(tg.numpy(), adj, atol=TOL)


def test_tied_qaoa_value_and_grad_match_jax():
    n, gammas, betas = 6, (0.55, -0.3), (0.25, 0.8)
    jc, jtie, jterms = JM.qaoa_maxcut_tied(n, gammas=gammas, betas=betas)
    tc, ttie, tterms = TM.qaoa_maxcut_tied(n, gammas=gammas, betas=betas)
    jf, ji, jt = JG.make_adjoint_value_and_grad(jc, jterms, tie=jtie)
    tf, ti, tt = TG.make_adjoint_value_and_grad(tc, tterms, tie=ttie,
                                                device="cpu")
    assert ti == ji and list(tt) == list(jt) == [0.55, -0.3, 0.25, 0.8]
    for shift in (0.0, 0.3):
        je, jg = jf(jt + shift)
        te, tg = tf(tt + shift)
        assert abs(float(te) - float(je)) < TOL
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    # batched members: one (K, 2^n) state, each row the scalar call's
    grid = np.stack([tt, tt + 0.1, tt - 0.2])
    be, bg = tf(grid)
    assert be.shape == (3,) and bg.shape == (3, 4)
    for k in range(3):
        e, g = tf(grid[k])
        assert abs(float(be[k]) - float(e)) < TOL
        np.testing.assert_allclose(bg[k].numpy(), g.numpy(), atol=TOL)


@pytest.mark.parametrize("tie", [{0: (0, 1.0)}, {1: (0, 0.0)},
                                 {1: (2, 1.0)}])
def test_tie_validation_errors_match_jax(tie):
    def call(G, M):
        c = M.random_circuit(2, 0, seed=0)
        c.h(0)
        c.rz(0.3, 1)
        kw = {"device": "cpu"} if G is TG else {}
        G.make_adjoint_value_and_grad(c, [(1.0, "Z0")], tie=tie, **kw)

    _same_error(call)


# ------------------------------------------------------------------- VQE
def test_run_vqe_matches_optax_adam():
    jc, terms = _tfim(JM)
    tc, _ = _tfim(TM)
    jt, je = JG.run_vqe(jc, terms, steps=20, learning_rate=0.1)
    tt, te = TG.run_vqe(tc, terms, steps=20, learning_rate=0.1,
                        device="cpu")
    assert te.shape == (20,)
    np.testing.assert_allclose(te, je, atol=VQE_TOL)
    np.testing.assert_allclose(tt, jt, atol=VQE_TOL)
    assert te[-1] < te[0] - 0.3


@pytest.mark.parametrize("restarts", [0, 4])
def test_run_vqe_tied_qaoa_matches_jax(restarts):
    jc, jtie, jterms = JM.qaoa_maxcut_tied(6, gammas=(1e-3,), betas=(1e-3,))
    tc, ttie, tterms = TM.qaoa_maxcut_tied(6, gammas=(1e-3,), betas=(1e-3,))
    kw = dict(steps=20, learning_rate=0.05, maximize=True,
              restarts=restarts, seed=1)
    jt, je = JG.run_vqe(jc, jterms, tie=jtie, **kw)
    tt, te = TG.run_vqe(tc, tterms, tie=ttie, device="cpu", **kw)
    assert te.shape == je.shape == (20,)
    np.testing.assert_allclose(te, je, atol=VQE_TOL)
    np.testing.assert_allclose(tt, jt, atol=VQE_TOL)


def test_run_vqe_takes_a_torch_optimizer_factory():
    tc, terms = _tfim(TM)
    made = []

    def sgd(params):
        made.append(params)
        return torch.optim.SGD(params, lr=0.05)

    fn, _, th0 = TG.make_adjoint_value_and_grad(tc, terms, device="cpu")
    theta, es = TG.run_vqe(tc, terms, steps=3, optimizer=sgd, device="cpu")
    assert len(made) == 1 and es.shape == (3,)
    # plain gradient descent: theta1 = theta0 - lr * grad(theta0)
    e0, g0 = fn(th0)
    assert abs(es[0] - float(e0)) < TOL
    want = th0 - 0.05 * g0.double().numpy()
    _, g1 = fn(want)
    _, g2 = fn(want - 0.05 * g1.double().numpy())
    want = want - 0.05 * g1.double().numpy() - 0.05 * g2.double().numpy()
    np.testing.assert_allclose(theta, want, atol=VQE_TOL)


def test_energy_landscape_matches_jax():
    jc, jtie, jterms = JM.qaoa_maxcut_tied(6, gammas=(0.3,), betas=(0.3,))
    tc, ttie, tterms = TM.qaoa_maxcut_tied(6, gammas=(0.3,), betas=(0.3,))
    g, b = np.meshgrid(np.linspace(0.1, 1.2, 7), np.linspace(0.1, 0.7, 5),
                       indexing="ij")
    grid = np.stack([g, b], -1).reshape(-1, 2)
    want = JG.energy_landscape(jc, jterms, grid, tie=jtie, max_batch_log2=9)
    got = TG.energy_landscape(tc, tterms, grid, tie=ttie, max_batch_log2=9,
                              device="cpu")
    np.testing.assert_allclose(got, want, atol=TOL)
    with pytest.raises(ValueError) as e_port:
        TG.energy_landscape(tc, tterms, np.zeros(3), tie=ttie, device="cpu")
    with pytest.raises(ValueError) as e_jax:
        JG.energy_landscape(jc, jterms, np.zeros(3), tie=jtie)
    assert str(e_port.value) == str(e_jax.value)


def test_complex128_value_and_grad_runs_in_float64():
    tc, terms = _tfim(TM)
    jc, _ = _tfim(JM)
    fn, _, th0 = TG.make_adjoint_value_and_grad(
        tc, terms, config=TConfig(dtype="complex128"), device="cpu")
    e, g = fn(th0)
    assert e.dtype == torch.float64
    # the exact energy from the f64 host reference
    exact = T.expectation_pauli_sum(tc, terms,
                                    TConfig(strategy="reference"),
                                    device="cpu")
    assert abs(float(e) - exact) < 1e-12
    jf, _, _ = JG.make_adjoint_value_and_grad(jc, terms)
    np.testing.assert_allclose(g.numpy(), np.asarray(jf(th0)[1]), atol=TOL)


@pytest.mark.parametrize("call", [
    lambda c, t: TG.adjoint_gradient(c, terms=t),
    lambda c, t: TG.parameter_shift(c, z_qubits=[0]),
    lambda c, t: TG.make_adjoint_value_and_grad(c, t),
    lambda c, t: TG.run_vqe(c, t, steps=1),
    lambda c, t: TG.energy_landscape(c, t, np.zeros((1, 8))),
], ids=["adjoint", "shift", "value_and_grad", "vqe", "landscape"])
def test_cuda_request_without_a_card_raises(monkeypatch, call):
    """Every entry point defaults to the card: with none, it raises
    instead of running on the CPU."""
    c, terms = _tfim(TM)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        call(c, terms)
