"""The port's sampling.py against the JAX package's.

Every deterministic function (norms, top amplitudes, Z expectations,
selected amplitudes, a projective measurement, counts, XEB) runs on one
numpy state through both packages: values within 1e-6, indices equal.  The
samplers draw from different streams (a ``torch.Generator`` here,
``jax.random`` there), so they are held to the exact probabilities by
chi-square and to their own seed, not to each other draw for draw.
``Simulator.sample`` up to n = 22 is the host sampler, whose samples equal
the JAX package's exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu import sampling as JS
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.ref import cpu as JREF

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import sampling as TS
from gpu_quantum_simulator_tpu_torch.ref import cpu as TREF

TOL = 1e-6
N = 12              # halves: (16, 128); direct sampler (<= STAGE_SPLIT_MIN)
N_STAGED = 21       # three-stage sampler (> STAGE_SPLIT_MIN)
SAMPLES = 40_000


def _state(n, seed, peaked=True):
    """A normalized complex64 state with a few dominant amplitudes."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    if peaked:
        v[rng.integers(0, 1 << n, 24)] *= rng.uniform(8, 30, 24)
    return (v / np.linalg.norm(v)).astype(np.complex64)


def _flat(v):
    return np.ascontiguousarray(v.real), np.ascontiguousarray(v.imag)


def _halves(v):
    re, im = (x.reshape(-1, 256) for x in _flat(v))
    return [np.ascontiguousarray(h) for h in
            (re[:, :128], re[:, 128:], im[:, :128], im[:, 128:])]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _chi_square(samples, probs, bins=256):
    """(chi2, bar): Pearson chi-square over ``bins`` equal index ranges,
    against dof + 6 sigma."""
    n = int(np.log2(probs.size))
    obs = np.bincount(samples >> (n - int(np.log2(bins))), minlength=bins)
    exp = probs.reshape(bins, -1).sum(axis=1) * len(samples)
    assert exp.min() >= 5
    dof = bins - 1
    return float(((obs - exp) ** 2 / exp).sum()), dof + 6 * np.sqrt(2 * dof)


@pytest.fixture(scope="module")
def state():
    v = _state(N, 3)
    return v, _flat(v), _halves(v)


def test_norms_match_jax(state):
    v, flat, halves = state
    assert abs(TS.norm_device(*_t(flat)) - float(JS.norm_device(*_j(flat)))) <= TOL
    assert abs(TS.norm_halves(*_t(halves))
               - float(JS.norm_halves(*_j(halves)))) <= TOL
    assert abs(TS.norm_halves(*_t(halves)) - 1.0) <= TOL


@pytest.mark.parametrize("k", [1, 8, 24])
def test_top_amplitudes_match_jax(state, k):
    v, flat, halves = state
    vals, idx = TS.top_amplitudes_device(*_t(flat), k)
    jvals, jidx = JS.top_amplitudes_device(*_j(flat), k)
    assert np.array_equal(idx, jidx) and np.max(np.abs(vals - jvals)) <= TOL
    hidx, hvals = TS.top_amplitudes_halves(*_t(halves), k=k, block_rows=4)
    jhidx, jhvals = JS.top_amplitudes_halves(*_j(halves), k=k, block_rows=4)
    assert np.array_equal(hidx, jhidx) and np.array_equal(hidx, idx)
    assert np.max(np.abs(hvals - jhvals)) <= TOL
    assert idx.dtype == np.int64 and hidx.dtype == np.int64


@pytest.mark.parametrize("qubits", [(0,), (7,), (11,), (2, 7, 9), (0, 3, 8, 10),
                                    ()], ids=str)
def test_expectation_z_matches_jax(state, qubits):
    v, flat, halves = state
    want = JS.expectation_z(*_j(flat), qubits, N)
    assert abs(TS.expectation_z(*_t(flat), qubits, N) - want) <= TOL
    got = TS.expectation_z_halves(*_t(halves), qubits, N)
    assert abs(got - JS.expectation_z_halves(*_j(halves), qubits, N)) <= TOL
    assert abs(got - want) <= TOL


def test_amplitudes_halves_match_jax(state):
    v, flat, halves = state
    idx = np.random.default_rng(4).integers(0, 1 << N, 500)
    idx[:4] = (0, 127, 128, (1 << N) - 1)
    got = TS.amplitudes_halves(*_t(halves), idx)
    assert np.array_equal(got, JS.amplitudes_halves(*_j(halves), idx))
    assert np.array_equal(got, v[idx])


@pytest.mark.parametrize("qubit,u", [(0, 0.1), (5, 0.9), (7, 0.5), (11, 0.3)])
def test_measure_qubit_matches_jax(state, qubit, u):
    v, flat, halves = state
    re, im, outcome = TS.measure_qubit_device(*_t(flat), qubit, u)
    jre, jim, joutcome = JS.measure_qubit_device(*_j(flat), qubit, u)
    assert outcome == joutcome
    assert np.max(np.abs(re.numpy() - np.asarray(jre))) <= TOL
    assert np.max(np.abs(im.numpy() - np.asarray(jim))) <= TOL
    bit = (np.arange(1 << N) >> qubit) & 1
    assert not re.numpy()[bit != outcome].any()
    assert abs(TS.norm_device(re, im) - 1.0) <= 1e-5


def test_counts_and_xeb_match_jax(state):
    v, flat, halves = state
    samples = np.random.default_rng(5).integers(0, 1 << N, 300)
    for bits in (True, False):
        assert TS.counts(samples, N, bits) == JS.counts(samples, N, bits)
    assert abs(TS.xeb_fidelity(*_t(flat), samples, N)
               - JS.xeb_fidelity(*_j(flat), samples, N)) <= 1e-5


@pytest.mark.parametrize("kind", ["direct", "staged", "halves"])
def test_samplers_follow_the_distribution_and_their_seed(kind):
    n = N if kind == "direct" else N_STAGED
    v = _state(n, 6, peaked=False)
    probs = np.abs(v.astype(np.complex128)) ** 2
    if kind == "halves":
        parts = _t(_halves(v))

        def draw(seed):
            return TS.sample_halves(*parts, n, SAMPLES, seed)
    else:
        parts = _t(_flat(v))

        def draw(seed):
            return TS.sample_state_device(*parts, n, SAMPLES, seed)

    assert (n <= TS.STAGE_SPLIT_MIN) == (kind == "direct")
    got = draw(1)
    assert got.dtype == np.int64 and got.shape == (SAMPLES,)
    assert got.min() >= 0 and got.max() < (1 << n)
    chi2, bar = _chi_square(got, probs)
    assert chi2 <= bar, (chi2, bar)
    assert np.array_equal(got, draw(1)) and not np.array_equal(got, draw(2))


def test_samplers_find_the_peaks():
    """A state on four basis indices: every sample is one of them, in the
    right proportions (flat, direct and staged, and halves)."""
    n = N_STAGED
    where = np.array([5, 128 + 9, (1 << 20) + 300, (1 << n) - 1])
    p = np.array([0.1, 0.2, 0.3, 0.4])
    v = np.zeros(1 << n, dtype=np.complex64)
    v[where] = np.sqrt(p) * np.exp(1j * np.arange(4))
    for got in (TS.sample_state_device(*_t(_flat(v)), n, 20000, 3),
                TS.sample_halves(*_t(_halves(v)), n, 20000, 3)):
        idx, cnt = np.unique(got, return_counts=True)
        assert np.array_equal(idx, where)
        assert np.max(np.abs(cnt / 20000 - p)) < 0.02


@pytest.mark.parametrize("seed", [0, 7])
def test_host_sampler_equals_jax_bit_for_bit(seed):
    v = _state(N, 8)
    want = JREF.sample(v, 5000, np.random.default_rng(seed))
    assert np.array_equal(TREF.sample(v, 5000, np.random.default_rng(seed)),
                          want)
    assert np.array_equal(TREF.cumulative_distribution(v),
                          JREF.cumulative_distribution(v))


@pytest.mark.parametrize("strategy,inplace", [("prefetch", None),
                                              ("prefetch", True),
                                              ("mxu", None)])
def test_simulator_sample_equals_jax(strategy, inplace):
    """Up to n = 22 both packages sample the final state on the host."""
    c = T.models.grover_like(10, 120, 5)
    jc = JM.grover_like(10, 120, 5)
    kw = dict(strategy=strategy, prefetch_inplace=inplace,
              precision="highest")
    got = T.Simulator(T.SimulatorConfig(**kw), device="cpu").sample(c, 2000, 9)
    want = JSimulator(JConfig(**kw)).sample(jc, 2000, seed=9)
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_simulator_sample_device_routes(monkeypatch):
    """Above n = 22 the samplers of sampling.py take over: the halves when
    prefetch runs in place, else the flat pair (the run itself is replaced
    by a small state here: the routes, not the engine, are under test)."""
    from gpu_quantum_simulator_tpu_torch.engine import simulator as S

    v = _state(N, 10)
    halves, flat = _t(_halves(v)), _t(_flat(v))
    calls = []
    monkeypatch.setattr(S.Simulator, "run_device_halves",
                        lambda self, c: (calls.append("halves") or halves, 1))
    monkeypatch.setattr(S.Simulator, "run_device",
                        lambda self, c, initial=None:
                        (calls.append("flat") or flat[0], flat[1], 1))
    monkeypatch.setattr(TS, "sample_halves", lambda *a: ("halves", a[4:]))
    monkeypatch.setattr(TS, "sample_state_device", lambda *a: ("flat", a[2:]))
    c = T.Circuit(23)
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch",
                                        prefetch_inplace=True), device="cpu")
    assert sim.sample(c, 10, seed=3) == ("halves", (23, 10, 3))
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cpu")
    assert sim.sample(c, 10, seed=3) == ("flat", (23, 10, 3))
    sim = T.Simulator(T.SimulatorConfig(strategy="auto"), device="cpu")
    assert sim.sample(T.Circuit(30), 10, seed=3) == ("halves", (30, 10, 3))
    assert calls == ["halves", "flat", "halves"]
