"""The copy probe kernels (kernels/copy.py, TPU kernel 11) against the JAX
package's ``scripts/dma_probe.py``, loaded as it is with importlib and run
in interpret mode: every route copies its operands, bit for bit, on the
same seeded inputs.  On a CPU tensor each wrapper is its plain version
(``copy_``); the CUDA kernels (csrc/copy_probe.cu) are held to it on the card
by chip_smoke.py and the harness gpu_quantum_simulator_tpu_torch/dma_probe.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gpu_quantum_simulator_tpu_torch import dma_probe
from gpu_quantum_simulator_tpu_torch.kernels import copy as KC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
R2 = 1 << (N - 8)


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "dma_probe_jax", os.path.join(REPO, "scripts", "dma_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True        # its CPU self-test mode, read at call time
    return mod


def _pair(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((R2, 256)).astype(np.float32)
            for _ in range(2)]


def _halves(pair):
    return [np.ascontiguousarray(h) for x in pair
            for h in (x[:, :128], x[:, 128:])]


def _same(got, want):
    return all(np.array_equal(g.numpy(), np.asarray(w))
               for g, w in zip(got, want))


@pytest.mark.parametrize("nops", [1, 2, 4])
@pytest.mark.parametrize("tile", [4, 16])
def test_grid_copy_matches_jax(jax_probe, nops, tile):
    pair = _pair(nops + tile)
    arrs = pair[:1] if nops == 1 else pair if nops == 2 else _halves(pair)
    want = jax_probe.grid_copy(N, tile, nops, np.float32)(*arrs)
    got = KC.grid_copy([torch.from_numpy(a) for a in arrs], tile)
    assert _same(got, want) and _same(got, arrs)


@pytest.mark.parametrize("tile,stages", [(4, 2), (4, 4), (2, 8)])
def test_stream_and_direct_copy_match_jax(jax_probe, tile, stages):
    pair = _pair(tile * stages)
    src = [torch.from_numpy(a) for a in pair]
    want = jax_probe.stream_copy(N, tile, stages, np.float32)(*pair)
    assert _same(KC.stream_copy(src, tile, stages), want)
    want = jax_probe.hbm_direct(N, tile, stages, np.float32)(*pair)
    out = [torch.empty_like(s) for s in src]
    assert KC.hbm_direct(src, tile, stages, out=out) == tuple(out)
    assert _same(out, want) and _same(out, pair)
    assert KC.stream_copy.launches == KC.hbm_direct.launches == 0


def test_copy_wrappers_raise():
    a = torch.zeros(R2, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        KC.grid_copy([a.to("meta")], 4)
    bad = (([a, a, a], 4),                        # three operands
           ([a], 5),                              # rows not a multiple
           ([a, torch.zeros(R2, 128)], 4),        # shapes differ
           ([a.double()], 4),                     # not float32
           ([a.t()], 4),                          # not contiguous
           ([torch.zeros(R2 * 256)], 4))          # not 2-D
    for srcs, tile in bad:
        with pytest.raises(ValueError, match="grid_copy"):
            KC.grid_copy(srcs, tile)
    big = torch.zeros(1024, 256)
    with pytest.raises(ValueError, match="shared memory"):
        KC.stream_copy([big], 512, 2)             # 2 x 512 KB stages
    with pytest.raises(ValueError, match="shared memory"):
        KC.hbm_direct([a], 4, 1)                  # needs two stages
    with pytest.raises(ValueError, match="outputs"):
        KC.grid_copy([a], 4, out=[a, a])


def test_probe_harness_measures_the_card_only():
    """The harness's routes cover every kernel and tile shape it reports,
    and it refuses to time anything but a card."""
    src = [torch.zeros(512, 256) for _ in range(2)]
    dst = [torch.empty_like(s) for s in src]
    names = [r[0] for r in dma_probe.routes(src, dst)]
    assert {"grid1_T32", "grid2_T128", "grid4_T512", "stream_T32_W4",
            "direct_T8_W8"} <= set(names)
    for name, s, d, call in dma_probe.routes(src, dst):
        call()
        assert all(torch.equal(a, b) for a, b in zip(s, d)), name
    with pytest.raises(RuntimeError, match="card"):
        dma_probe.measure(10, device="cpu")
