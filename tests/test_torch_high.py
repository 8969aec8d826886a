"""The "high" precision rung of the port against the JAX package.

At "high" every real product of a mat step is the 3-pass bf16 split
``xh.mh + xl.mh + xh.ml`` with float32 accumulation (the JAX package's
``_make_dot("high")``); perm, tswap and mono steps stay exact gathers.
The port's plain versions run here; the CUDA kernel (csrc/mat_high.cu) is
held to them on the card by chip_smoke.py.  Also the fences of the slice
at its edges: the "default" rung and n > 30, also at n = 30, where the
engine runs in place by default.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.config import resolve_precision
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.kernels.block import (
    bf16_split, mat_high_plain, split_tables)

SPLIT_TOL = 1e-5     # relative: both sum exact bf16 products in float32
HIGH_TOL = 4e-6      # tests/test_precision_auto.py:68, the JAX rung's bar
JAX_HIGH_TOL = 8e-6  # two 4e-6 budgets (schoolbook here, Karatsuba there)


def _port(precision):
    return T.Simulator(T.SimulatorConfig(strategy="prefetch",
                                         precision=precision), device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_split_product_matches_jax_make_dot(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    m = (rng.standard_normal((256, 256)) / 16).astype(np.float32)
    want = np.asarray(JPF._make_dot("high", jnp.float32)(
        jnp.asarray(x), jnp.asarray(m)))
    xs, ms = bf16_split(torch.from_numpy(x)), bf16_split(torch.from_numpy(m))
    got = (xs[0] @ ms[0] + xs[1] @ ms[0] + xs[0] @ ms[1]).numpy()
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= SPLIT_TOL * scale
    # and it is a different product from the float32 one
    exact = x.astype(np.float64) @ m.astype(np.float64)
    assert 0 < np.max(np.abs(got - exact)) <= 1e-4 * scale


def test_split_parts_are_bf16_exact():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        1000).astype(np.float32))
    hi, lo = bf16_split(x)
    for part in (hi, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.all((x - hi - lo).abs() <= x.abs() * 2.0 ** -16)


def test_split_tables_layout():
    """split_tables stores [A_hi, A_lo, B_hi, B_lo], each as [n][k], so
    that the mat kernel reads the transposed table (M itself)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(np.float32))
    w = split_tables(a, b)
    assert w.shape == (2, 4, 256, 256) and w.dtype == torch.bfloat16
    for j, t in enumerate((a, b)):
        hi, lo = bf16_split(t.transpose(-1, -2))
        assert torch.equal(w[:, 2 * j].float(), hi)
        assert torch.equal(w[:, 2 * j + 1].float(), lo)


def test_mat_high_plain_is_the_schoolbook_split():
    rng = np.random.default_rng(4)
    re, im, a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for s in ((32, 256), (32, 256), (256, 256), (256, 256)))
    got = mat_high_plain(re, im, a, b)
    x = re.double() + 1j * im.double()
    want = x @ (a.double() + 1j * b.double())
    err = max(float((got[0] - want.real).abs().max()),
              float((got[1] - want.imag).abs().max()))
    assert 0 < err <= 1e-4 * float(want.abs().max())


def test_high_rung_circuit_against_highest_and_jax():
    """grover_like(12, 600, 41): the JAX rung's own bar, strictly above 0
    (the rounding ran), and within 8e-6 of the JAX package's "high" run."""
    c = T.models.grover_like(12, 600, 41)
    hi = _port("high").run(c)
    ref = _port("highest").run(c)
    err = float(np.max(np.abs(hi - ref)))
    assert 0.0 < err < HIGH_TOL, err
    jhi = JSimulator(JConfig(strategy="prefetch", precision="high")).run(
        JM.grover_like(12, 600, 41))
    assert float(np.max(np.abs(hi - np.asarray(jhi)))) < JAX_HIGH_TOL


def test_auto_is_high_from_24():
    assert resolve_precision("auto", 23) == "highest"
    assert resolve_precision("auto", 24) == "high"
    for n in (24, 30):
        TPF.check_slice(n, resolve_precision("auto", n))


def test_check_slice_fences():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TPF.check_slice(12, "default")
    with pytest.raises(ValueError, match="ceiling"):
        TPF.check_slice(31, "highest")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TPF.check_slice(30, "default")   # in place by default, still fenced
    TPF.check_slice(30, "high")          # n = 30 is in, flat and in place


@pytest.mark.parametrize("n,kw,exc", [
    (31, {}, ValueError),
    (30, {"precision": "default"}, NotImplementedError),   # in place there
    (30, {"prefetch_inplace": True, "precision": "default"},
     NotImplementedError),
    (12, {"precision": "default"}, NotImplementedError),
])
def test_simulator_raises_before_running(n, kw, exc):
    c = T.models.grover_like(n, 40, 1)
    cfg = T.SimulatorConfig(strategy="prefetch", **kw)
    TPF._RUN_CACHE.clear()
    with pytest.raises(exc, match="ROADMAP|ceiling"):
        T.Simulator(cfg, device="cpu").run(c)
    assert not TPF._RUN_CACHE            # nothing was planned or built


def test_high_mat_chain_norm_matches_jax():
    """200 chained "high" mat steps at n = 12 on a normalised random state,
    eight random unitary tables taken in turn: the port's plain step, flat
    (kernels/block.py) and in place on halves (kernels/split.py), against
    the JAX package's mat step over ``_make_dot("high")`` on the same
    tables and state.  After the 200 steps the norms agree within 1e-6 and
    the amplitudes within the rung's bar: the port's sums drift no more
    than the JAX package's.  The JAX step is its schoolbook form, the
    port's: its default Karatsuba form is another sum, whose norm here
    ends ~5e-6 from its own schoolbook one (both wander by ~1e-6 along the
    way at this width, each fp32 sum rounding in its own order)."""
    from gpu_quantum_simulator_tpu_torch.kernels import split as KS
    from gpu_quantum_simulator_tpu_torch.kernels.block import run_block_plain

    n, slots, cap = 12, 8, TPF.CAP_STEPS
    rng = np.random.default_rng(12)
    mats = []
    for _ in range(slots):
        q, r = np.linalg.qr(rng.standard_normal((256, 256))
                            + 1j * rng.standard_normal((256, 256)))
        mats.append(q * (np.diag(r) / np.abs(np.diag(r))))
    a = np.stack([m.real.T for m in mats]).astype(np.float32)
    b = np.stack([m.imag.T for m in mats]).astype(np.float32)
    v = rng.standard_normal((2, 1 << (n - 8), 256))
    v = (v / np.linalg.norm(v)).astype(np.float32)
    scal = np.zeros((200, 4 + 2 * cap), np.int32)
    scal[:, 0] = 1
    scal[:, 4 + cap] = np.arange(200) % slots
    step = JPF._make_mat_step("schoolbook",
                              JPF._make_dot("high", jnp.float32),
                              jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(scal.reshape(-1)), cap)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    mono = torch.zeros(slots, 256, dtype=torch.int32)
    jre, jim = jnp.asarray(v[0]), jnp.asarray(v[1])
    flat = (torch.from_numpy(v[0]), torch.from_numpy(v[1]))
    halves = tuple(h.contiguous() for x in flat
                   for h in (x[:, :128], x[:, 128:]))

    def norm(re, im):
        return float(np.sum(np.asarray(re, np.float64) ** 2)
                     + np.sum(np.asarray(im, np.float64) ** 2))

    n0 = norm(*flat)
    for i in range(200):
        # the JAX step reads slot idx(j) = scal[i * len + 4 + cap]: offset j
        # into the flattened table by whole rows
        jre, jim = step(i * (4 + 2 * cap), jre, jim)
        row = scal[i].tolist()
        flat = run_block_plain(row, *flat, ta, tb, mono, 1, cap,
                               precision="high")
        halves = KS.run_split_block_plain(row, halves, ta, tb, mono, 1, cap,
                                          precision="high")
    got_j, got_t = norm(jre, jim), norm(*flat)
    assert abs(got_t - got_j) <= 1e-6 * n0
    assert np.max(np.abs(flat[0].numpy() - np.asarray(jre))) <= HIGH_TOL
    assert np.max(np.abs(flat[1].numpy() - np.asarray(jim))) <= HIGH_TOL
    assert torch.equal(torch.cat(halves[:2], 1), flat[0])
    assert torch.equal(torch.cat(halves[2:], 1), flat[1])
    # a unitary keeps the norm: what is left is the rung's rounding
    assert abs(got_t / n0 - 1) <= 1e-4 and abs(got_j / n0 - 1) <= 1e-4
