"""The port's noisy trajectories against the JAX package's, on the CPU.

Deterministic parts are held exactly or at 1e-6: every ensemble pass
(``_measure_ensemble``, ``_pauli_ensemble``, ``_pauli2_ensemble``,
``_damp_ensemble``, ``_apply_kraus`` in each of the JAX package's forms,
``_noise_run_fn``/``_noise_run_params``, ``_apply_noise``,
``_flip_where``) fed the same state and the same uniforms ``u``;
``with_noise``'s items; the readout flips of ``sample_noisy`` (numpy
seeding).  Random results are held by statistics at fixed seeds:
trajectory averages, ``sample_noisy`` frequencies and
``expectation_noisy`` within 4 standard errors of the DensitySimulator's
exact answer and within 6 of the JAX package's estimate at the same shot
count.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import density as JD
from gpu_quantum_simulator_tpu import dynamic as JY
from gpu_quantum_simulator_tpu import models as JM

import torch

from gpu_quantum_simulator_tpu_torch import density as TD
from gpu_quantum_simulator_tpu_torch import dynamic as TY
from gpu_quantum_simulator_tpu_torch import models as TM

PASS_TOL = 1e-6
N, S = 6, 2


def _state(seed, n=N, s=S):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=1 << (n + s))
         + 1j * rng.normal(size=1 << (n + s))).reshape(1 << s, -1)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = v.reshape(-1)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    return (jnp.asarray(re), jnp.asarray(im)), (torch.from_numpy(re),
                                                torch.from_numpy(im))


U = np.array([0.1, 0.35, 0.7, 0.95], np.float32)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PASS_TOL)


# ------------------------------------------------------- ensemble passes
@pytest.mark.parametrize("q", range(N))
def test_measure_damp_flip_match_jax(q):
    (jre, jim), (tre, tim) = _state(10 + q)
    ju, tu = jnp.asarray(U), torch.from_numpy(U)
    want = JY._measure_ensemble(jre, jim, q, N, S, ju)
    got = TY._measure_ensemble(tre, tim, q, N, S, tu)
    _close(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(TY._damp_ensemble(tre, tim, q, N, S, torch.tensor(0.3), tu),
           JY._damp_ensemble(jre, jim, q, N, S, jnp.float32(0.3), ju))
    _close(TY._damp_ensemble(tre, tim, q, N, S, 0.3, tu),
           JY._damp_ensemble(jre, jim, q, N, S, jnp.float32(0.3), ju))
    cond = np.array([1, 0, 1, 0], np.int32)
    _close(TY._flip_where(tre, tim, q, N, S, torch.from_numpy(cond)),
           JY._flip_where(jre, jim, q, N, S, jnp.asarray(cond)))


@pytest.mark.parametrize("probs", [(0.2, 0.3, 0.1), (0.0, 0.0, 0.5),
                                   (0.25, 0.25, 0.25)])
def test_pauli_passes_match_jax(probs):
    (jre, jim), (tre, tim) = _state(3)
    ju, tu = jnp.asarray(U), torch.from_numpy(U)
    for q in range(N):
        _close(TY._pauli_ensemble(tre, tim, q, N, S,
                                  torch.tensor(probs), tu),
               JY._pauli_ensemble(jre, jim, q, N, S,
                                  jnp.asarray(probs, jnp.float32), ju))
    for qa, qb in ((0, 5), (4, 1), (2, 3)):
        p = sum(probs)
        _close(TY._pauli2_ensemble(tre, tim, qa, qb, N, S, torch.tensor(p),
                                   tu),
               JY._pauli2_ensemble(jre, jim, qa, qb, N, S, jnp.float32(p),
                                   ju))


def test_noise_runs_and_single_events_match_jax():
    (jre, jim), (tre, tim) = _state(5)
    run = [TY.Noise("depolarizing", 0, 0.4), TY.Noise("dephasing", 5, 0.6),
           TY.Noise("bit_flip", 2, 0.3),
           TY.Noise("amplitude_damping", 3, 0.5),
           TY.Noise("depolarizing2", 1, 0.7, 4)]
    jrun = [JY.Noise(r.kind, r.qubit, r.p, r.qubit2) for r in run]
    us = np.random.default_rng(1).random((len(run), 1 << S)).astype(
        np.float32)
    tspec, tps = TY._noise_run_params(run, torch.float32, "cpu")
    jspec, jps = JY._noise_run_params(jrun, jnp.float32)
    assert tspec == jspec
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    _close(TY._noise_run_fn(tspec, N, S)(tre, tim, tps, torch.from_numpy(us)),
           JY._noise_run_fn(jspec, N, S)(jre, jim, jps, jnp.asarray(us)))
    for t, j, u in zip(run, jrun, us):
        _close(TY._apply_noise(tre, tim, t, N, S, torch.from_numpy(u),
                               torch.float32),
               JY._apply_noise(jre, jim, j, N, S, jnp.asarray(u),
                               jnp.float32))


def _random_kraus(dim, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k * dim, dim)) + 1j * rng.normal(size=(k * dim, dim))
    q, _ = np.linalg.qr(a)
    return [q[m * dim:(m + 1) * dim, :] for m in range(k)]


@pytest.mark.parametrize("qs,n", [((0,), 13), ((4,), 13), ((8,), 13),
                                  ((11,), 13), ((0, 1), 13), ((0, 8), 13),
                                  ((1, 9), 13), ((0, 10), 13), ((2, 12), 13),
                                  ((7, 9), 13), ((8, 12), 13), ((1,), 6),
                                  ((2, 5), 6)])
def test_kraus_forms_match_jax(qs, n):
    s = 1
    assert TY._kraus_form(qs, n) == JY._kraus_form(qs, n)
    ks = _random_kraus(1 << len(qs), 3, seed=sum(qs) + n)
    (jre, jim), (tre, tim) = _state(70 + sum(qs), n=n, s=s)
    u = np.array([0.05, 0.9], np.float32)
    _close(TY._apply_kraus(tre, tim, TY.KrausNoise(tuple(ks), qs), n, s,
                           torch.from_numpy(u), torch.float32),
           JY._apply_kraus(jre, jim, JY.KrausNoise(tuple(ks), qs), n, s,
                           jnp.asarray(u), jnp.float32))


def test_with_noise_items_match_jax():
    for kw in ({"p1": 0.01, "p2": 0.02}, {"p1": 0.01, "p2": 0.05,
                                          "correlated": True},
               {"kind": "amplitude_damping", "p1": 0.1}):
        got = TY.with_noise(TM.random_circuit(4, 30, seed=2), **kw).items
        want = JY.with_noise(JM.random_circuit(4, 30, seed=2), **kw).items
        assert [type(i).__name__ for i in got] == \
            [type(i).__name__ for i in want]
        for a, b in zip(got, want):
            if isinstance(a, TY.Noise):
                assert (a.kind, a.qubit, a.p, a.qubit2) == \
                    (b.kind, b.qubit, b.p, b.qubit2)
            else:
                assert (a.name, a.qubits, a.params) == \
                    (b.name, b.qubits, b.params)


# ------------------------------------------------------------ statistics
def _pops_sigma(p, shots):
    return np.sqrt(np.maximum(p * (1 - p), 1.0 / shots) / shots)


def _check_pops(got, exact, jax_est, shots):
    s = _pops_sigma(exact, shots)
    assert np.all(np.abs(got - exact) < 4 * s), (got, exact, s)
    assert np.all(np.abs(got - jax_est) < 6 * np.sqrt(2) * s), (got,
                                                                jax_est, s)


def _density(D, M, n, kind, q, p, seed_pre=4, seed_post=5, q2=None,
             kraus=None):
    nc = D.NoisyCircuit(n, items=list(M.random_circuit(n, 20,
                                                       seed=seed_pre).gates))
    if kraus is not None:
        nc.channel(kraus, *q)
    elif kind == "depolarizing2":
        nc.channel(kind, q, q2, p=p)
    else:
        kw = {"gamma": p} if kind == "amplitude_damping" else {"p": p}
        nc.channel(kind, q, **kw)
    nc.items.extend(M.random_circuit(n, 20, seed=seed_post).gates)
    return D.DensitySimulator(**({"device": "cpu"} if D is TD else {})
                              ).run(nc).probabilities()


def _trajectory_pops(Y, M, n, kind, q, p, shots, seed, q2=None,
                     kraus=None):
    dc = Y.DynamicCircuit(n)
    dc.items.extend(M.random_circuit(n, 20, seed=4).gates)
    if kraus is not None:
        dc.noise_kraus(kraus, *q)
    elif kind == "depolarizing2":
        dc.noise(kind, q, p, qubit2=q2)
    else:
        dc.noise(kind, q, p)
    dc.items.extend(M.random_circuit(n, 20, seed=5).gates)
    kw = {"device": "cpu"} if Y is TY else {}
    acc = np.zeros(1 << n)
    for r in Y.run_dynamic_batched(dc, shots=shots, seed=seed,
                                   return_states=True, **kw):
        acc += np.abs(r.state) ** 2
    return acc / shots


@pytest.mark.parametrize("kind,p,q2", [
    ("depolarizing", 0.35, None), ("dephasing", 0.6, None),
    ("bit_flip", 0.3, None), ("amplitude_damping", 0.45, None),
    ("depolarizing2", 0.5, 2)])
def test_trajectory_average_matches_density_and_jax(kind, p, q2):
    n, shots = 3, 4096
    exact = _density(TD, TM, n, kind, 1, p, q2=q2)
    np.testing.assert_allclose(exact, _density(JD, JM, n, kind, 1, p, q2=q2),
                               atol=1e-6)
    got = _trajectory_pops(TY, TM, n, kind, 1, p, shots, 9, q2=q2)
    want = _trajectory_pops(JY, JM, n, kind, 1, p, shots, 9, q2=q2)
    _check_pops(got, exact, want, shots)


@pytest.mark.parametrize("qs", [(1,), (2, 0)])
def test_kraus_trajectory_matches_density_and_jax(qs):
    n, shots = 3, 4096
    ks = _random_kraus(1 << len(qs), 3, seed=7)
    exact = _density(TD, TM, n, None, qs, None, kraus=ks)
    got = _trajectory_pops(TY, TM, n, None, qs, None, shots, 41, kraus=ks)
    want = _trajectory_pops(JY, JM, n, None, qs, None, shots, 41, kraus=ks)
    _check_pops(got, exact, want, shots)


def test_per_shot_noise_matches_jax_exactly():
    """run_dynamic's noise and Kraus events take host uniforms in the JAX
    package's order: equal bits, states within float32 rounding."""
    def prog(Y):
        dc = Y.DynamicCircuit(2, num_clbits=1)
        dc.h(0).cx(0, 1)
        dc.noise("depolarizing", 0, 0.5)
        dc.noise("amplitude_damping", 1, 0.4)
        dc.noise_kraus(_random_kraus(2, 2, seed=3), 0)
        dc.measure(1, 0)
        return dc

    got = TY.run_dynamic(prog(TY), shots=20, seed=3, return_states=True,
                         device="cpu")
    want = JY.run_dynamic(prog(JY), shots=20, seed=3, return_states=True)
    assert [r.clbits for r in got] == [r.clbits for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.state, b.state, atol=2e-5)


def _noisy_density(n, p):
    nc = TD.NoisyCircuit(n)
    for item in TY.with_noise(TM.bell(), p1=p, p2=p).items:
        if isinstance(item, TY.Noise):
            nc.channel("depolarizing", item.qubit, p=item.p)
        else:
            nc.items.append(item)
    return TD.DensitySimulator(device="cpu").run(nc)


def test_sample_noisy_matches_density_and_jax():
    shots = 8192
    exact = _noisy_density(2, 0.25).probabilities()
    got = np.bincount(TY.sample_noisy(TM.bell(), shots, p1=0.25, p2=0.25,
                                      seed=6, device="cpu"),
                      minlength=4) / shots
    want = np.bincount(JY.sample_noisy(JM.bell(), shots, p1=0.25, p2=0.25,
                                       seed=6), minlength=4) / shots
    _check_pops(got, exact, want, shots)


def test_readout_flips_match_jax():
    c = TM.random_circuit(2, 0, seed=0).x(0)       # |01> -> index 1
    assert set(TY.sample_noisy(c, 64, seed=3, device="cpu").tolist()) == {1}
    got = TY.sample_noisy(c, 64, seed=3, readout_error=1.0, device="cpu")
    assert set(got.tolist()) == {2}
    jc = JM.random_circuit(2, 0, seed=0).x(0)
    # a deterministic circuit: the outcomes before the flips agree, so the
    # numpy-seeded flips make the samples equal
    np.testing.assert_array_equal(
        TY.sample_noisy(c, 4096, seed=3, readout_error=0.25, device="cpu"),
        JY.sample_noisy(jc, 4096, seed=3, readout_error=0.25))


@pytest.mark.parametrize("pauli", ["Z0 Z1", "X0 X1"])
def test_expectation_noisy_matches_density_and_jax(pauli):
    p, shots = 0.3, 8192
    rho = _noisy_density(2, p)
    P = {"Z": np.diag([1.0, -1.0]), "X": np.array([[0.0, 1.0], [1.0, 0.0]])}
    op = np.kron(P[pauli[0]], P[pauli[0]])
    exact = float(np.real(np.trace(rho.matrix() @ op)))
    got = TY.expectation_noisy(TM.bell(), [(1.0, pauli)], shots=shots, p1=p,
                               p2=p, seed=3, device="cpu")
    want = JY.expectation_noisy(JM.bell(), [(1.0, pauli)], shots=shots,
                                p1=p, p2=p, seed=3)
    s = np.sqrt((1 - exact ** 2) / shots)
    assert abs(got - exact) < 4 * s, (got, exact)
    assert abs(got - want) < 6 * np.sqrt(2) * s, (got, want)


def test_expectation_noisy_zero_noise_matches_jax():
    terms = [(0.7, "Z0"), (-0.4, "X1 Z2"), (0.25, "III")]
    got = TY.expectation_noisy(TM.random_circuit(3, 30, seed=8), terms,
                               shots=8, seed=0, device="cpu")
    want = JY.expectation_noisy(JM.random_circuit(3, 30, seed=8), terms,
                                shots=8, seed=0)
    assert abs(got - want) < 1e-5
    with pytest.raises(ValueError) as e_port:
        TY.expectation_noisy(TM.ghz(4), terms, max_width=4, device="cpu")
    with pytest.raises(ValueError) as e_jax:
        JY.expectation_noisy(JM.ghz(4), terms, max_width=4)
    assert str(e_port.value) == str(e_jax.value)


def test_thermal_trajectory_matches_exact():
    t1, t2, t = 10.0, 12.0, 4.0
    dc = TY.DynamicCircuit(1)
    dc.x(0)
    dc.thermal(0, t1, t2, t)
    shots = 4096
    res = TY.run_dynamic_batched(dc, shots=shots, seed=2, return_states=True,
                                 device="cpu")
    p1 = np.mean([np.abs(r.state[1]) ** 2 for r in res])
    exact = np.exp(-t / t1)
    assert abs(p1 - exact) < 4 * np.sqrt(exact * (1 - exact) / shots)
