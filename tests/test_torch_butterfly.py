"""The port's lane-layout ops module (ops/pallas_kernels.py) against the JAX
package's: ``apply_butterfly_high`` (TPU kernel 10; the JAX kernel runs in
interpret mode) and ``swap_low_high``, on seeded numpy inputs.  On a CPU
tensor the wrapper is its plain version; the CUDA kernel
(csrc/butterfly_high.cu) is held to it on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu.ops import pallas_kernels as JPK

from gpu_quantum_simulator_tpu_torch.engine import pallas_engine as TPE
from gpu_quantum_simulator_tpu_torch.kernels import wide as KW
from gpu_quantum_simulator_tpu_torch.ops import apply as TA
from gpu_quantum_simulator_tpu_torch.ops import pallas_kernels as PK

TOL = 1e-6           # the same float32 products and sums; |amp| <= ~0.2


def _unitary(rng):
    q, r = np.linalg.qr(rng.standard_normal((2, 2))
                        + 1j * rng.standard_normal((2, 2)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _state(rng, n):
    v = rng.standard_normal((2, 1 << (n - 7), 128))
    return (v / np.linalg.norm(v)).astype(np.float32)


@pytest.mark.parametrize("n", [9, 10, 11, 12])
def test_butterfly_matches_jax_every_high_bit(n):
    rng = np.random.default_rng(n)
    v = _state(rng, n)
    for high_bit in range(n - 7):
        u = _unitary(rng)
        want = JPK.apply_butterfly_high(jnp.asarray(v[0]), jnp.asarray(v[1]),
                                        u, high_bit, interpret=True)
        got = PK.apply_butterfly_high_plain(torch.from_numpy(v[0]),
                                            torch.from_numpy(v[1]), u,
                                            high_bit)
        for g, w in zip(got, want):
            assert np.max(np.abs(g.numpy() - np.asarray(w))) <= TOL


def test_butterfly_is_apply_1q_on_qubit_high_bit_plus_7():
    """The same gate as the megakernel arm's primitive on the flat pair."""
    rng = np.random.default_rng(3)
    n = 11
    v = _state(rng, n)
    for high_bit in range(n - 7):
        u = _unitary(rng)
        got = PK.apply_butterfly_high(torch.from_numpy(v[0]),
                                      torch.from_numpy(v[1]), u, high_bit)
        want = TA.apply_1q(torch.from_numpy(v[0].reshape(-1)),
                           torch.from_numpy(v[1].reshape(-1)), u.real,
                           u.imag, high_bit + 7, n)
        for g, w in zip(got, want):
            assert np.max(np.abs(g.reshape(-1).numpy() - w.numpy())) <= TOL


def test_butterfly_wrapper_writes_out_and_in_place():
    rng = np.random.default_rng(4)
    v = _state(rng, 10)
    u = _unitary(rng)
    re, im = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    want = PK.apply_butterfly_high_plain(re, im, u, 1)
    out = (torch.empty_like(re), torch.empty_like(im))
    assert PK.apply_butterfly_high(re, im, u, 1, out=out) is out
    own = (re.clone(), im.clone())
    PK.apply_butterfly_high(*own, torch.from_numpy(u), 1, out=own)
    for got in (out, own):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the plain version launches nothing
    assert PK.apply_butterfly_high.launches == 0


def test_butterfly_wrapper_raises():
    u = np.eye(2)
    ok = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        PK.apply_butterfly_high(ok.to("meta"), ok.to("meta"), u, 0)
    for re, hb in ((torch.zeros(8, 64), 0), (torch.zeros(6, 128), 0),
                   (ok, 3), (ok, -1), (torch.zeros(1024), 0)):
        with pytest.raises(ValueError, match="butterfly"):
            PK.apply_butterfly_high(re, re.clone(), u, hb)
    with pytest.raises(ValueError, match="2 x 2"):
        PK.apply_butterfly_high(ok, ok.clone(), np.eye(4), 0)


@pytest.mark.parametrize("n", [9, 10, 11, 12])
def test_swap_low_high_matches_jax(n):
    rng = np.random.default_rng(20 + n)
    v = _state(rng, n)
    for low, qubit in ((0, 7), (6, n - 1), (3, 8)):
        got = PK.swap_low_high(torch.from_numpy(v[0]), torch.from_numpy(v[1]),
                               low, qubit, n)
        want = JPK.swap_low_high(jnp.asarray(v[0]), jnp.asarray(v[1]), low,
                                 qubit, n)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_the_module_is_the_ops_of_the_engines():
    """``apply_block128`` is kernel 9's wrapper and ``swap_low_high`` the
    pallas engine's, as the JAX engine imports them from its module."""
    assert PK.apply_block128 is KW.apply_block128
    assert TPE.swap_low_high is PK.swap_low_high
    assert TPE.apply_block128 is PK.apply_block128


def test_ops_take_the_jax_keywords():
    """Calls written for the JAX ops' signatures (the state as ``s_re`` /
    ``s_im``, keyword-only ``tile_rows=`` and ``interpret=``) run here and
    give the JAX ops' results; the TPU-only keywords are checked as the
    JAX package checks them and otherwise ignored."""
    import inspect

    for name in ("apply_block128", "apply_butterfly_high"):
        jsig = inspect.signature(getattr(JPK, name)).parameters
        tsig = inspect.signature(getattr(PK, name)).parameters
        for p, param in jsig.items():
            assert p in tsig and tsig[p].kind == param.kind, (name, p)
    rng = np.random.default_rng(11)
    v = _state(rng, 10)
    m = np.linalg.qr(rng.standard_normal((128, 128))
                     + 1j * rng.standard_normal((128, 128)))[0]
    m_re, m_im = (np.ascontiguousarray(x, dtype=np.float32)
                  for x in (m.real, m.imag))
    want = JPK.apply_block128(s_re=jnp.asarray(v[0]), s_im=jnp.asarray(v[1]),
                              m_re=jnp.asarray(m_re), m_im=jnp.asarray(m_im),
                              tile_rows=4, interpret=True)
    got = PK.apply_block128(s_re=torch.from_numpy(v[0]),
                            s_im=torch.from_numpy(v[1]),
                            m_re=torch.from_numpy(m_re),
                            m_im=torch.from_numpy(m_im), tile_rows=4,
                            interpret=True)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= TOL
    u = _unitary(rng)
    want = JPK.apply_butterfly_high(s_re=jnp.asarray(v[0]),
                                    s_im=jnp.asarray(v[1]), u=u, high_bit=2,
                                    interpret=True)
    got = PK.apply_butterfly_high(s_re=torch.from_numpy(v[0]),
                                  s_im=torch.from_numpy(v[1]), u=u,
                                  high_bit=2, interpret=True)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= TOL
    x = torch.from_numpy(v[0])
    for tile in (0, 3, 2.0, True):      # min(tile, R = 8) must divide R
        with pytest.raises(ValueError, match="tile_rows"):
            PK.apply_block128(x, x, torch.from_numpy(m_re),
                              torch.from_numpy(m_im), tile_rows=tile)
    with pytest.raises(ValueError, match="interpret"):
        PK.apply_butterfly_high(x, x, u, 0, interpret="yes")
    with pytest.raises(TypeError):
        PK.apply_block128(x, x, torch.from_numpy(m_re),
                          torch.from_numpy(m_im), 512)   # keyword-only
