"""Block kernel: the port's plain version against the JAX Pallas kernel.

At n=11 with a 4-row tile (two tiles, tswap k=1..2, one cross-tile bit for
the steered prologue) the same synthetic blocks — every step kind, plain
and steered, and a prologue-only block — are packed once by
``materialize_entries``, expanded by both packages' table expanders and run
by the JAX ``get_block_kernel`` (interpret mode) and by the port's
``run_block_plain``.  On a CPU tensor ``run_block`` is that plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.kernels.block import (
    run_block, run_block_plain)

N = 11
TILE = 4
TOL = 1e-5          # f32 products summed in another order than the JAX dot
NUM_BLOCKS = 6


def _unitary(rng, d):
    q, r = np.linalg.qr(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _monomial(rng, d):
    u = np.zeros((d, d), dtype=complex)
    u[np.arange(d), rng.permutation(d)] = np.exp(
        1j * rng.uniform(-np.pi, np.pi, d))
    return u


def _blocks(rng, logt):
    def mat(width, mono=False, operm=None):
        d = 1 << width
        u = _monomial(rng, d) if mono else _unitary(rng, d)
        pos = tuple(int(p) for p in rng.permutation(TPF.LOCAL_QUBITS)[:width])
        return (u, pos, operm)

    perm, mono = logt + 1, logt + 2
    full = TPF._Block()
    steps = ([(0, mat(7)), (mono, mat(5, mono=True))]
             + [(perm, v) for v in range(TPF.LANE_QUBITS)]
             + [(k, 0) for k in range(1, logt + 1)]
             + [(0, mat(3, operm=TPF._window_swap_index(2))),
                (mono, mat(7, mono=True))])
    for kind, arg in steps:
        full.kinds.append(kind)
        if kind in (0, mono):
            full.midx.append(len(full.mats))
            full.mats.append(arg)
        else:
            full.midx.append(arg)
    blocks = [full]
    for first in ((0, mat(6)), (mono, mat(4, mono=True)), (perm, 3),
                  (logt, 0), None):
        b = TPF._Block(prologue=(1, 0))
        if first is not None:
            kind, arg = first
            b.kinds += [kind, 0]
            if kind in (0, mono):
                b.midx += [0, 1]
                b.mats += [arg, mat(2)]
            else:
                b.midx += [arg, 0]
                b.mats += [mat(2)]
        blocks.append(b)
    assert len(blocks) == NUM_BLOCKS
    return blocks


@pytest.fixture(scope="module")
def case():
    """Shrunken tiles in both packages; one table group for all blocks."""
    mp = pytest.MonkeyPatch()
    for pf in (JPF, TPF):
        mp.setattr(pf, "TILE_ROWS", TILE)
    JPF._KERNEL_CACHE.clear()
    JPF._CHAIN_CACHE.clear()
    try:
        logt = int(np.log2(TPF.tile_rows(N)))
        rng = np.random.default_rng(11)
        groups = TPF.materialize_entries(_blocks(rng, logt), TPF.CAP_STEPS,
                                         TPF.CAP_MATS, np.float32)
        assert len(groups) == 1
        cap, sizes, scal, *tabs = groups[0]
        R2 = 1 << (N - TPF.LOCAL_QUBITS)
        re = rng.standard_normal((R2, TPF.DVIEW)).astype(np.float32)
        im = rng.standard_normal((R2, TPF.DVIEW)).astype(np.float32)
        ja, jb = JPF._get_expander(sizes[0], cap, np.float32)(
            *(jnp.asarray(t) for t in tabs))
        ta, tb, src = TPF.expand_tables(*(torch.from_numpy(t) for t in tabs))
        kernel = JPF.get_block_kernel(N, np.float32, "highest", True)
        ptab = JPF.perm_table(np.float32)
        jout = [tuple(np.asarray(x) for x in kernel(
                    jnp.asarray(scal[i]), jnp.asarray(re), jnp.asarray(im),
                    ja[i], jb[i], ptab))
                for i in range(NUM_BLOCKS)]
        yield dict(logt=logt, scal=scal, mono=tabs[-1], re=re, im=im,
                   ja=np.asarray(ja), jb=np.asarray(jb), ta=ta, tb=tb,
                   src=src, jout=jout)
    finally:
        mp.undo()
        JPF._KERNEL_CACHE.clear()
        JPF._CHAIN_CACHE.clear()


def test_expander_gather_equals_jax_expander(case):
    assert np.array_equal(case["ta"].numpy(), case["ja"])
    assert np.array_equal(case["tb"].numpy(), case["jb"])
    # mono_src picks the single 1 of each column of every mono a-table
    a, src, mono = case["ta"], case["src"].long(), case["mono"]
    hits = torch.gather(a, -2, src[..., None, :])[..., 0, :]
    for b, s in zip(*np.nonzero(mono)):
        assert torch.equal(hits[b, s], torch.ones(TPF.DVIEW))


@pytest.mark.parametrize("entry", range(NUM_BLOCKS))
def test_plain_block_matches_jax_kernel(case, entry):
    scal = case["scal"][entry]
    args = (case["ta"][entry], case["tb"][entry], case["src"][entry],
            case["logt"], TPF.CAP_STEPS)
    re, im = torch.from_numpy(case["re"]), torch.from_numpy(case["im"])
    got = run_block_plain(scal, re, im, *args)
    want = case["jout"][entry]
    assert np.max(np.abs(got[0].numpy() - want[0])) <= TOL
    assert np.max(np.abs(got[1].numpy() - want[1])) <= TOL
    # on a CPU tensor the wrapper is the plain version
    routed = run_block(scal, re, im, *args)
    assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])


def test_block_wrapper_refuses_other_devices(case):
    """No silent fallback: a tensor neither on the CPU nor on a CUDA card
    raises instead of running the plain version somewhere else."""
    R2 = 1 << (N - TPF.LOCAL_QUBITS)
    re = torch.empty((R2, TPF.DVIEW), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        run_block(case["scal"][0], re, re, case["ta"][0], case["tb"][0],
                  case["src"][0], case["logt"], TPF.CAP_STEPS)
