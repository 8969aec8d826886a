"""The "high" precision rung of the port against the JAX package.

At "high" every real product of a mat step is the 3-pass bf16 split
``xh.mh + xl.mh + xh.ml`` with float32 accumulation (the JAX package's
``_make_dot("high")``); perm, tswap and mono steps stay exact gathers.
The port's plain versions run here; the CUDA kernel (csrc/mat_high.cu) is
held to them on the card by chip_smoke.py.  Also the fences of the slice
at its edges: n > 30, an unknown rung and complex128 (float32-only), also
at n = 30, where the engine runs in place by default; the "default" rung
runs (tests/test_torch_default.py).
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
    HIGH_SLOT_WORDS, bf16_split, mat_high_plain, split_tables)

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


def _decode_image(w):
    """The kernel's view of ``split_tables`` (csrc/wgmma_high.cuh), read
    back into dense [n][k] float32 tables (A_hi, A_lo, B_hi, B_lo) for
    every slot.  Per 64-column block cb and k-chunk q of 16 the bfloat16
    values are four parts of 16-byte core matrices [kc 2][n 64][8]; wgmma
    position p of the chunk holds k 4 ((p % 8) // 2) + 2 (p // 8) + p % 2."""
    u = w.numpy().view(np.uint16).reshape(w.shape[0], 4, 16, 4, 2, 64, 8)
    v = (u.astype(np.uint32) << 16).view(np.float32)
    out = np.zeros((w.shape[0], 4, 256, 256), np.float32)
    for cb in range(4):
        n = cb * 64 + np.arange(64)
        for q in range(16):
            for kc in range(2):
                for i in range(8):
                    p = 8 * kc + i
                    k = (16 * q + 4 * ((p % 8) // 2) + 2 * (p // 8)
                         + p % 2)
                    out[:, :, n, k] = v[:, cb, q, :, kc, :, i]
    return out


def test_split_tables_layout():
    """split_tables writes, for every 64-column block and k-chunk of 16,
    A_hi, A_lo, B_hi, B_lo as bfloat16, each read back as [n][k]: the
    transposed table (M itself)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(np.float32))
    w = split_tables(a, b)
    assert w.shape == (2, HIGH_SLOT_WORDS) and w.dtype == torch.int32
    dense = _decode_image(w)
    for j, t in enumerate((a, b)):
        hi, lo = bf16_split(t.transpose(-1, -2))
        assert np.array_equal(dense[:, 2 * j], hi.numpy())
        assert np.array_equal(dense[:, 2 * j + 1], lo.numpy())
    # and a leading dimension of entries is kept
    assert split_tables(a[None], b[None]).shape == (1, 2, HIGH_SLOT_WORDS)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_split_tables_match_jax_make_dot_splits(seed):
    """The image's parts, read back as [n][k], are bit for bit the JAX
    package's ``_make_dot("high")`` splits of the tables: mh = m as bf16,
    ml = the bf16 of m - mh."""
    rng = np.random.default_rng(seed)
    a, b = ((rng.standard_normal((3, 256, 256)) / 16).astype(np.float32)
            for _ in range(2))
    dense = _decode_image(split_tables(torch.from_numpy(a),
                                       torch.from_numpy(b)))
    for j, m in enumerate((a, b)):
        mt = jnp.asarray(np.swapaxes(m, -1, -2))
        mh = mt.astype(jnp.bfloat16)
        ml = (mt - mh.astype(jnp.float32)).astype(jnp.bfloat16)
        for part, want in ((2 * j, mh), (2 * j + 1, ml)):
            assert np.array_equal(
                dense[:, part].view(np.uint32),
                np.asarray(want.astype(jnp.float32)).view(np.uint32))


def _one_mat_block(seed):
    """One "high" mat step (slot 1 of two) on an (R2, 256) state at n=12,
    the tables random unitaries."""
    rng = np.random.default_rng(seed)
    us = []
    for _ in range(2):
        q, r = np.linalg.qr(rng.standard_normal((256, 256))
                            + 1j * rng.standard_normal((256, 256)))
        us.append(q * (np.diag(r) / np.abs(np.diag(r))))
    a = torch.from_numpy(np.stack([u.real.T for u in us]).astype(np.float32))
    b = torch.from_numpy(np.stack([u.imag.T for u in us]).astype(np.float32))
    cap = TPF.CAP_STEPS
    row = [1, 0, 0, 0] + [0] * cap + [1] + [0] * (cap - 1)
    x = rng.standard_normal((2, 16, 256)).astype(np.float32)
    return row, a, b, torch.zeros(2, 256, dtype=torch.int32), x, cap


def _halves(re, im):
    return tuple(h.contiguous() for x in (re, im)
                 for h in (x[:, :128], x[:, 128:]))


@pytest.mark.parametrize("site", ["flat", "inplace"])
@pytest.mark.parametrize("bad", ["bf16 layout", "dtype", "slots", "words",
                                 "strided"])
def test_high_tables_fences(site, bad):
    """Both launch sites of the "high" mat step refuse tables that are not
    ``split_tables`` of the entry's slots, before choosing a device."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import run_block
    from gpu_quantum_simulator_tpu_torch.kernels.split import run_split_block

    row, a, b, mono, x, cap = _one_mat_block(8)
    good = split_tables(a, b)
    wrong = {
        "bf16 layout": good.view(torch.bfloat16).reshape(2, 4, 256, 256),
        "dtype": good.float(),
        "slots": good[:1],
        "words": good[:, :-4],
        "strided": torch.stack([good, good], -1)[..., 0],
    }[bad]
    re, im = torch.from_numpy(x[0]), torch.from_numpy(x[1])
    with pytest.raises(ValueError, match="high_tables"):
        if site == "flat":
            run_block(row, re, im, a, b, mono, 1, cap, precision="high",
                      high_tables=wrong)
        else:
            run_split_block(row, _halves(re, im), a, b, mono, 1, cap,
                            precision="high", high_tables=wrong)


@pytest.mark.parametrize("seed", [9, 10])
def test_plain_flat_and_inplace_high_steps_equal(seed):
    """One "high" mat step through both launch sites on the CPU (their
    plain versions), given the tables ``split_tables`` makes: the in-place
    halves joined equal the flat pair bit for bit, and both equal
    ``mat_high_plain`` on the slot's tables."""
    from gpu_quantum_simulator_tpu_torch.kernels.block import run_block
    from gpu_quantum_simulator_tpu_torch.kernels.split import run_split_block

    row, a, b, mono, x, cap = _one_mat_block(seed)
    high = split_tables(a, b)
    re, im = torch.from_numpy(x[0]), torch.from_numpy(x[1])
    flat = run_block(row, re, im, a, b, mono, 1, cap, precision="high",
                     high_tables=high)
    halves = run_split_block(row, _halves(re, im), a, b, mono, 1, cap,
                             precision="high", high_tables=high)
    assert torch.equal(torch.cat(halves[:2], 1), flat[0])
    assert torch.equal(torch.cat(halves[2:], 1), flat[1])
    want = mat_high_plain(re, im, a[1], b[1])
    assert torch.equal(flat[0], want[0]) and torch.equal(flat[1], want[1])


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
    TPF.check_slice(12, "default")       # every rung runs
    with pytest.raises(ValueError, match="ceiling"):
        TPF.check_slice(31, "highest")
    TPF.check_slice(30, "default")       # in place by default, at any rung
    TPF.check_slice(30, "high")          # n = 30 is in, flat and in place
    with pytest.raises(ValueError, match="rungs"):
        TPF.check_slice(12, "bogus")


# The "default" rung runs at every width (tests/test_torch_default.py);
# what still raises before anything is planned is complex128, which the
# engine refuses as the JAX package does, in place at n = 30 and flat.
@pytest.mark.parametrize("n,kw,exc", [
    (31, {}, ValueError),
    (30, {"dtype": "complex128", "precision": "default"},
     ValueError),                                           # in place there
    (30, {"prefetch_inplace": True, "dtype": "complex128"}, ValueError),
    (12, {"dtype": "complex128", "precision": "default"}, ValueError),
])
def test_simulator_raises_before_running(n, kw, exc):
    c = T.models.grover_like(n, 40, 1)
    cfg = T.SimulatorConfig(strategy="prefetch", **kw)
    TPF._RUN_CACHE.clear()
    with pytest.raises(exc, match="ceiling|float32-only"):
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
