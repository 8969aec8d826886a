"""The port's classical shadows against the JAX package's, on the CPU.

The bases come from the same numpy draw as in the JAX package, so they
are EQUAL; the outcomes come from a seeded torch generator (in place of
``jax.random.categorical``), so estimates agree in distribution: each is
held to the exact expectation within 4 standard errors (computed from the
snapshots) and to the JAX package's estimate from the same number of
snapshots within 6.  ``shadows_expectation`` and
``shadows_reduced_density`` are host numpy copies: equal on equal pools.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu import shadows as JS

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch import shadows as TS


def _single_estimates(bases, outcomes, pauli, n):
    """Per-snapshot estimator values of one Pauli string (mean = the
    estimate with groups=1; their spread gives the standard error)."""
    from gpu_quantum_simulator_tpu_torch.observables import _parse_pauli

    est = np.ones(bases.shape[0])
    for q, ax in _parse_pauli(pauli, n).items():
        match = bases[:, q] == TS._AXIS[ax]
        sign = 1.0 - 2.0 * ((outcomes >> q) & 1)
        est = est * np.where(match, 3.0 * sign, 0.0)
    return est


@pytest.mark.parametrize("pauli,exact", [
    ("Z0 Z1", 1.0), ("Z1 Z3", 1.0), ("XXXX", 1.0), ("Z0", 0.0), ("X0", 0.0),
    ("Y0 Y1 X2 X3", -1.0)])
def test_ghz_estimates_match_exact_and_jax(pauli, exact):
    S = 12000
    bases, outcomes = TS.shadow_snapshots(TM.ghz(4), S, seed=3,
                                          device="cpu")
    jb, jo = JS.shadow_snapshots(JM.ghz(4), S, seed=3)
    np.testing.assert_array_equal(bases, jb)
    assert outcomes.shape == (S,) and outcomes.dtype == np.int64
    est = _single_estimates(bases, outcomes, pauli, 4)
    jest = _single_estimates(jb, jo, pauli, 4)
    se = max(est.std(), jest.std(), 1e-3) / np.sqrt(S)
    assert abs(est.mean() - exact) < 4 * se, (est.mean(), exact, se)
    assert abs(est.mean() - jest.mean()) < 6 * np.sqrt(2) * se


def test_shadows_expectation_and_reduced_density_match_jax_on_a_pool():
    c = TM.ghz(4)
    pool = TS.shadow_snapshots(c, 4000, seed=11, device="cpu")
    terms = [(0.5, "Z0 Z1"), (0.25, "XXXX"), (2.0, "IIII"), (-1.0, "Y2")]
    assert TS.shadows_expectation(c, terms, _snapshot_data=pool) == \
        JS.shadows_expectation(JM.ghz(4), terms, _snapshot_data=pool)
    np.testing.assert_array_equal(
        TS.shadows_reduced_density(*pool, [0, 2]),
        JS.shadows_reduced_density(*pool, [0, 2]))
    with pytest.raises(ValueError) as got:
        TS.shadows_reduced_density(*pool, [0, 0])
    with pytest.raises(ValueError) as want:
        JS.shadows_reduced_density(*pool, [0, 0])
    assert str(got.value) == str(want.value)


def test_random_state_estimate_matches_exact():
    c = TM.random_circuit(5, 60, seed=12)
    terms = [(1.0, "Z0 Z2"), (0.7, "X1"), (-0.5, "Y3 Z4")]
    exact = T.expectation_pauli_sum(c, terms, device="cpu")
    S = 20000
    bases, outcomes = TS.shadow_snapshots(c, S, seed=7, device="cpu")
    est = sum(coeff * _single_estimates(bases, outcomes, p, 5)
              for coeff, p in terms)
    assert abs(est.mean() - exact) < 4 * est.std() / np.sqrt(S)
    got = TS.shadows_expectation(c, terms, snapshots=S, seed=7, device="cpu")
    assert abs(got - exact) < 0.25


def test_chunking_does_not_change_the_pool():
    c = TM.random_circuit(4, 30, seed=2)
    a = TS.shadow_snapshots(c, 300, seed=5, device="cpu")
    b = TS.shadow_snapshots(c, 300, seed=5, max_batch_log2=6, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    # a product state's reduced density from the pool
    c2 = TM.random_circuit(2, 0, seed=0)
    c2.ry(0.9, 0)
    b2, o2 = TS.shadow_snapshots(c2, 20000, seed=12, device="cpu")
    r1 = TS.shadows_reduced_density(b2, o2, [0])
    v = np.array([np.cos(0.45), np.sin(0.45)])
    assert np.max(np.abs(r1 - np.outer(v, v))) < 0.06


def test_cuda_request_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TS.shadow_snapshots(TM.ghz(3), 8),
                 lambda: TS.shadows_expectation(TM.ghz(3), [(1.0, "Z0")],
                                                snapshots=8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
