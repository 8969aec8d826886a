"""The join of a state's parts into one complex host array
(``ops/apply.join_state``) on the CPU: bit for bit the plain numpy join at
every chunking, from tensors and from arrays; ``run_detailed`` returns the
join of ``run_device``'s parts; a host join counts no join from a card.
The join of parts on a card runs in ``chip_smoke.py`` (``check_join``)."""

import numpy as np
import pytest
import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import telemetry
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit
from gpu_quantum_simulator_tpu_torch.ops import apply as A

CHUNK = 64          # elements of a part a chunk carries in these tests
SHAPES = {
    # (1-D, 2-D (S, 2^n)) below one chunk, one chunk exactly, and 2.5 or
    # 3.27 chunks
    "below": ((40,), (2, 16)),
    "one": ((CHUNK,), (4, 16)),
    "ragged": ((3 * CHUNK + 17,), (5, 32)),
}


def plain_join(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    out = np.empty(re.shape, np.complex64 if re.dtype == np.float32
                   else np.complex128)
    out.real = re
    out.imag = im
    return out


def parts(shape, dtype, seed):
    """Two parts with signed zeros, infinities, a nan and subnormals among
    random values."""
    rng = np.random.default_rng(seed)
    re, im = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
    special = np.array([-0.0, np.inf, -np.inf, np.nan,
                        np.finfo(dtype).smallest_subnormal], dtype)
    re.reshape(-1)[:special.size] = special
    im.reshape(-1)[-special.size:] = special[::-1]
    return re, im


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype == np.complex64 else np.uint64)


@pytest.mark.parametrize("source", ["tensor", "array"])
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("size", sorted(SHAPES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_join_is_the_plain_join_bit_for_bit(monkeypatch, source, rank,
                                            size, dtype):
    monkeypatch.setattr(A, "CHUNK_BYTES", CHUNK * np.dtype(dtype).itemsize)
    shape = SHAPES[size][rank - 1]
    re, im = parts(shape, dtype, seed=rank * 10 + len(size))
    want = plain_join(re, im)
    args = ((torch.from_numpy(re.copy()), torch.from_numpy(im.copy()))
            if source == "tensor" else (re, im))
    got = A.join_state(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(bits(got), bits(want))


def test_strided_and_reversed_arrays_join_as_numpy_does(monkeypatch):
    monkeypatch.setattr(A, "CHUNK_BYTES", CHUNK * 4)
    re, im = parts((2, 300), np.float32, seed=7)
    for a, b in ((re[:, ::2], im[:, ::2]), (re[::-1, ::-3], im[::-1, ::-3]),
                 (re.T, im.T)):
        assert np.array_equal(bits(A.join_state(a, b)), bits(plain_join(a, b)))
    with pytest.raises(ValueError, match="differ in shape"):
        A.join_state(re, im[:1])


def _circuit(n, seed):
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for q in range(n):
        c.append("h", q)
    for layer in range(4):
        for q in range(layer % 2, n - 1, 2):
            c.append("cx", q, q + 1)
        for q in range(n):
            c.append("rz", q, params=(float(rng.uniform(-3, 3)),))
    return c


@pytest.mark.parametrize("strategy", ["mxu", "prefetch"])
def test_run_detailed_is_the_join_of_run_device(strategy):
    """At n = 10 on the CPU, with the chunk at its default: the same
    vector bit for bit, and neither counter of joins from a card moves."""
    sim = T.Simulator(T.SimulatorConfig(strategy=strategy), device="cpu")
    c = _circuit(10, seed=len(strategy))
    before = telemetry.counters()
    got = sim.run_detailed(c).state
    re, im, _ = sim.run_device(c)
    want = A.join_state(re, im)
    after = telemetry.counters()
    assert np.array_equal(bits(got), bits(want))
    assert np.array_equal(bits(want), bits(plain_join(re.numpy(),
                                                      im.numpy())))
    for name in ("state_joins", "state_join_overlapped"):
        assert after.get(name, 0) == before.get(name, 0)
