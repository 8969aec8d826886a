"""The port's ensemble views (``dynamic._bit_ctx``) and the JAX package's
Kraus lowering names (``_kraus_form``), on the CPU.

The JAX package lowers lane qubits (q < 7) to 0/1 matmuls on its (R, 128)
TPU layout; the port keeps the plain (S, hi, 2, 2^q) view, whose bit-q
flip is an exact ``flip``.  What is held here is the RESULT of each view
against dense little-endian algebra — the flip, the indicator, Pauli
hits, collapse, damping, Kraus events in every one of the JAX package's
forms and ``_flip_where`` — on a (12 + s)-qubit ensemble, one case per
JAX branch (lane, rank-4 row, rank-5 row).  Reference basis conventions:
quantum_simulator.c:205-208 (little-endian, qubit k = bit k).
"""

import numpy as np
import pytest

import torch

from gpu_quantum_simulator_tpu import dynamic as JY
from gpu_quantum_simulator_tpu_torch import dynamic as D
from gpu_quantum_simulator_tpu_torch.dynamic import (KrausNoise, _apply_kraus,
                                                     _kraus_form)

X = np.array([[0, 1], [1, 0]], complex)
Y = np.array([[0, -1j], [1j, 0]], complex)
Z = np.array([[1, 0], [0, -1]], complex)


def _rand_state(m, seed):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=1 << m) + 1j * rng.normal(size=1 << m)
    psi /= np.linalg.norm(psi)
    return psi


def _parts(psi):
    return (torch.tensor(psi.real, dtype=torch.float32),
            torch.tensor(psi.imag, dtype=torch.float32))


def _host(r, i, S):
    return (r.numpy() + 1j * i.numpy()).reshape(S, -1)


def _dense_1q(vec, q, n, M):
    v = vec.reshape(1 << (n - 1 - q), 2, 1 << q)
    return np.einsum("ab,xbz->xaz", M, v).reshape(-1)


def _dense_2q(vec, qa, qb, n, M):
    hi, mid, lo = 1 << (n - 1 - qb), 1 << (qb - qa - 1), 1 << qa
    v = vec.reshape(hi, 2, mid, 2, lo)
    return np.einsum("baBA,hBwAl->hbwal",
                     M.reshape(2, 2, 2, 2), v).reshape(-1)


@pytest.mark.parametrize("q", [0, 3, 6, 7, 9, 11])
def test_bit_ctx_flip_and_indicator(q):
    n, s = 12, 2
    shape, flip, b1, bc = D._bit_ctx(q, n, s, torch.float32, "cpu")
    assert bc == (1 << s,) + (1,) * (len(shape) - 1)
    psi = _rand_state(n + s, q)
    re, _ = _parts(psi)
    got = flip(re.reshape(shape)).reshape(1 << s, -1).numpy()
    blocks = psi.real.astype(np.float32).reshape(1 << s, -1)
    idx = np.arange(1 << n) ^ (1 << q)
    np.testing.assert_array_equal(got, blocks[:, idx])
    ind = torch.broadcast_to(b1, shape).reshape(1 << s, -1)[0].numpy()
    np.testing.assert_array_equal(ind, (np.arange(1 << n) >> q) & 1)


@pytest.mark.parametrize("q", [0, 3, 6, 7, 9, 11])
def test_pauli_hits_matches_dense(q):
    n, s = 12, 2
    S = 1 << s
    psi = _rand_state(n + s, 10 + q)
    re, im = _parts(psi)
    xh = torch.tensor([True, False, False, False])
    yh = torch.tensor([False, True, False, False])
    zh = torch.tensor([False, False, True, False])
    got = _host(*D._pauli_hits(re, im, q, n, s, xh, yh, zh), S)
    blocks = psi.reshape(S, -1)
    for k, M in enumerate([X, Y, Z, np.eye(2)]):
        np.testing.assert_allclose(got[k], _dense_1q(blocks[k], q, n, M),
                                   atol=1e-6)


@pytest.mark.parametrize("q", [0, 5, 8, 11])
def test_measure_and_damp_match_dense(q):
    n, s = 12, 2
    S = 1 << s
    psi = _rand_state(n + s, 50 + q)
    re, im = _parts(psi)
    u = torch.tensor([0.1, 0.35, 0.7, 0.95])
    r2, i2, out = D._measure_ensemble(re, im, q, n, s, u)
    got = _host(r2, i2, S)
    blocks = psi.reshape(S, -1)
    for k in range(S):
        v = blocks[k].reshape(1 << (n - 1 - q), 2, 1 << q)
        p1 = np.sum(np.abs(v[:, 1, :]) ** 2)
        o = 1 if float(u[k]) < p1 else 0
        assert int(out[k]) == o
        proj = np.zeros_like(v)
        proj[:, o, :] = v[:, o, :] / np.sqrt(p1 if o else 1 - p1)
        np.testing.assert_allclose(got[k], proj.reshape(-1), atol=2e-5)

    g = 0.3
    got = _host(*D._damp_ensemble(re, im, q, n, s, torch.tensor(g), u), S)
    for k in range(S):
        v = blocks[k].reshape(1 << (n - 1 - q), 2, 1 << q)
        p1 = np.sum(np.abs(v[:, 1, :]) ** 2)
        if float(u[k]) < g * p1:
            w = np.zeros_like(v)
            w[:, 0, :] = v[:, 1, :] / np.sqrt(p1)
        else:
            w = v.copy()
            w[:, 1, :] *= np.sqrt(1 - g)
            w /= np.sqrt(1 - g * p1)
        np.testing.assert_allclose(got[k], w.reshape(-1), atol=2e-5)


@pytest.mark.parametrize("q,form", [(0, "lane"), (4, "lane"),
                                    (8, "row1"), (11, "row1")])
def test_kraus_1q_forms(q, form):
    n, s = 13, 1
    S = 1 << s
    assert _kraus_form((q,), n) == JY._kraus_form((q,), n) == form
    g = 0.25
    K0 = np.array([[1, 0], [0, np.sqrt(1 - g)]], complex)
    K1 = np.array([[0, np.sqrt(g)], [0, 0]], complex)
    psi = _rand_state(n + s, 70 + q)
    re, im = _parts(psi)
    u = torch.tensor([0.05, 0.9])
    got = _host(*_apply_kraus(re, im, KrausNoise((K0, K1), (q,)), n, s, u,
                              torch.float32), S)
    blocks = psi.reshape(S, -1)
    for k in range(S):
        ys = [_dense_1q(blocks[k], q, n, K) for K in (K0, K1)]
        ps = [np.sum(np.abs(y) ** 2) for y in ys]
        idx = min(int(np.sum(float(u[k]) >= np.cumsum(ps))), 1)
        np.testing.assert_allclose(got[k], ys[idx] / np.sqrt(ps[idx]),
                                   atol=2e-5)


@pytest.mark.parametrize("qa,qb,form", [(0, 1, "lane"), (0, 8, "tile"),
                                        (1, 9, "tile"), (0, 10, "mixed"),
                                        (2, 12, "mixed"), (7, 9, "row2"),
                                        (8, 12, "row2")])
def test_kraus_2q_forms(qa, qb, form):
    n, s = 13, 1
    S = 1 << s
    assert _kraus_form((qa, qb), n) == JY._kraus_form((qa, qb), n) == form
    KA = np.sqrt(0.7) * np.diag([1, 1, 1, -1]).astype(complex)
    KB = np.sqrt(0.3) * np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], complex)
    psi = _rand_state(n + s, 90 + qa * 16 + qb)
    re, im = _parts(psi)
    u = torch.tensor([0.2, 0.8])
    got = _host(*_apply_kraus(re, im, KrausNoise((KA, KB), (qa, qb)), n, s,
                              u, torch.float32), S)
    blocks = psi.reshape(S, -1)
    for k in range(S):
        ys = [_dense_2q(blocks[k], qa, qb, n, K) for K in (KA, KB)]
        ps = [np.sum(np.abs(y) ** 2) for y in ys]
        idx = min(int(np.sum(float(u[k]) >= np.cumsum(ps))), 1)
        np.testing.assert_allclose(got[k], ys[idx] / np.sqrt(ps[idx]),
                                   atol=2e-5)


def test_flip_where_lane_and_row():
    n, s = 12, 2
    psi = _rand_state(n + s, 7)
    re, im = _parts(psi)
    cond = torch.tensor([1, 0, 1, 0])
    for q in (2, 8, 11):
        got = _host(*D._flip_where(re, im, q, n, s, cond), 4)
        blocks = psi.reshape(4, -1)
        for k in range(4):
            want = _dense_1q(blocks[k], q, n, X) if k % 2 == 0 else blocks[k]
            np.testing.assert_allclose(got[k], want, atol=1e-6)
