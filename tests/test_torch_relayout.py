"""Relayout kernel: the port's plain version against the JAX Pallas kernel.

The same random state and random sigma go through the JAX
``get_relayout_kernel`` (interpret mode) and the port's
``run_relayout_plain``; a pure copy, so the results must be equal.
Geometries: n=11 with 1-row blocks (three exposed bits) and n=16 at the
main path's 64-row blocks (two exposed bits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.kernels.relayout import (
    run_relayout, run_relayout_plain)


@pytest.mark.parametrize("n,tile,tr,seed", [
    (11, 4, 1, 0), (11, 4, 1, 1), (16, 512, 64, 2)])
def test_plain_relayout_equals_jax_kernel(monkeypatch, n, tile, tr, seed):
    for pf in (JPF, TPF):
        monkeypatch.setattr(pf, "TILE_ROWS", tile)
        monkeypatch.setattr(pf, "RELAYOUT_TILE_ROWS", tr)
    JPF._KERNEL_CACHE.clear()
    try:
        R2 = 1 << (n - TPF.LOCAL_QUBITS)
        assert TPF.relayout_rows(n) == tr
        m = int(np.log2(R2 // tr))
        rng = np.random.default_rng(seed)
        sigma = rng.permutation(m).astype(np.int32)
        if m > 1 and np.array_equal(sigma, np.arange(m)):
            sigma = np.roll(sigma, 1)
        re = rng.standard_normal((R2, TPF.DVIEW)).astype(np.float32)
        im = rng.standard_normal((R2, TPF.DVIEW)).astype(np.float32)
        scal = np.zeros(4 + 2 * JPF.CAP_STEPS + JPF.RELAYOUT_SLOTS, np.int32)
        scal[1] = 3
        scal[4 : 4 + m] = sigma
        want = JPF.get_relayout_kernel(n, np.float32, True)(
            jnp.asarray(scal), jnp.asarray(re), jnp.asarray(im))
        got = run_relayout_plain(sigma, torch.from_numpy(re),
                                 torch.from_numpy(im), tr)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert not np.array_equal(got[0].numpy(), re)   # it moved data
        # on a CPU tensor the wrapper is the plain version
        routed = run_relayout(sigma, torch.from_numpy(re),
                              torch.from_numpy(im), tr)
        assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])
    finally:
        JPF._KERNEL_CACHE.clear()


def test_relayout_rejects_bad_sigma_and_devices():
    re = torch.zeros((8, TPF.DVIEW))
    with pytest.raises(ValueError, match="sigma needs 3"):
        run_relayout([0, 1], re, re, 1)
    meta = torch.empty((8, TPF.DVIEW), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        run_relayout([0, 1, 2], meta, meta, 1)
