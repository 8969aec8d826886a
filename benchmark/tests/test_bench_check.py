"""The comparisons that decide ``correct``, on states made here."""

import math

import numpy as np
import torch

from benchmark import check
from benchmark.harness import to_circuit


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return v / np.linalg.norm(v)


def _forms(v):
    """The same state as a host vector, a flat pair, the in-place
    engine's four column halves (the port's own split) and a pair of four
    shard lists."""
    from gpu_quantum_simulator_tpu_torch.kernels.split import split_halves

    re = torch.tensor(v.real, dtype=torch.float32)
    im = torch.tensor(v.imag, dtype=torch.float32)
    re0, re1 = split_halves(re.reshape(-1, 256))
    im0, im1 = split_halves(im.reshape(-1, 256))
    shards = (list(re.reshape(4, -1)), list(im.reshape(4, -1)))
    return (v.astype(np.complex64), (re, im), (re0, re1, im0, im1),
            shards)


def test_every_form_reads_the_same():
    v = _state(12)
    ref = torch.tensor(v)
    noisy = v + 1e-3 * _state(12, 1)
    errs = [check.amp_err(f, ref) for f in _forms(noisy)]
    want = np.linalg.norm(noisy - v) / np.linalg.norm(v)
    assert np.allclose(errs, want, rtol=1e-3), errs
    assert all(check.amp_err(f, ref) < 1e-6 for f in _forms(v))


def test_halves_as_the_in_place_engine_leaves_them():
    import gpu_quantum_simulator_tpu_torch as T
    from gpu_quantum_simulator_tpu_torch.models import grover_like

    c = grover_like(12, 300, 4)
    sim = T.Simulator(T.SimulatorConfig(strategy="prefetch",
                                        prefetch_inplace=True), device="cpu")
    halves, _ = sim.run_device_halves(c)
    ref = torch.tensor(T.Simulator(T.SimulatorConfig(strategy="reference"),
                                   device="cpu").run(c))
    assert check.amp_err(halves, ref) < 1e-5
    assert check.amp_err(halves[::-1], ref) > 0.1


def test_wrong_size_or_non_finite_reads_inf():
    v = _state(10)
    ref = torch.tensor(v)
    assert check.amp_err(v[:-1].astype(np.complex64), ref) == math.inf
    bad = v.astype(np.complex64)
    bad[3] = np.nan
    assert check.amp_err(bad, ref) == math.inf


def test_shots_bad_counts_missing_extra_and_outside():
    assert check.shots_bad(np.arange(10), 4, 10) == 0
    assert check.shots_bad(np.arange(5), 4, 10) == 5
    assert check.shots_bad(np.array([0, 16, -1, 3]), 4, 4) == 2
    assert check.shots_bad(np.zeros(4), 4, 4) == 4      # not integers


def test_shots_z_separates_the_right_distribution_from_others():
    n, num = 14, 100000
    v = _state(n, 2) * np.exp(_state(n, 3).real * 40)   # uneven weights
    v /= np.linalg.norm(v)
    ref = torch.tensor(v)
    p = np.abs(v) ** 2
    rng = np.random.default_rng(5)
    good = rng.choice(1 << n, size=num, p=p / p.sum())
    assert check.shots_z(good, ref) < 5
    assert check.shots_z(good ^ 1, ref) > 20
    assert check.shots_z(rng.integers(1 << n, size=num), ref) > 20


def test_circuits_reach_the_port_through_public_methods():
    gates = [("cx", (0, 1), ()), ("rz", (2,), (0.5,)), ("sx", (1,), ())]
    c = to_circuit(gates, 3)
    assert [(g.name, g.qubits, g.params) for g in c.gates] == gates
