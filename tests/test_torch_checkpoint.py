"""The port's checkpoints against the JAX package's: the same files (keys
and meta record), so either package loads what the other wrote, and a
halves checkpoint resumes the in-place engine."""

import json

import numpy as np
import pytest
import torch

from gpu_quantum_simulator_tpu.utils import checkpoint as JC
from gpu_quantum_simulator_tpu_torch import Circuit, Simulator, SimulatorConfig
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.engine.prefetch import join_halves
from gpu_quantum_simulator_tpu_torch.ops.apply import join_state
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference
from gpu_quantum_simulator_tpu_torch.utils import checkpoint as TC

N = 10


def _state(seed, n=N, dtype=np.float32):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    return v.real.astype(dtype), v.imag.astype(dtype)


def _halves(seed, n=N):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(1 << (n - 8), 128)).astype(np.float32)
                 for _ in range(4))


@pytest.mark.parametrize("kind", ["numpy", "tensor", "float64"])
def test_flat_round_trip(tmp_path, kind):
    re, im = _state(1, dtype=np.float64 if kind == "float64" else np.float32)
    src = ((torch.from_numpy(re), torch.from_numpy(im)) if kind == "tensor"
           else (re, im))
    path = str(tmp_path / "s.npz")
    TC.save_state(path, *src, N, meta={"note": kind})
    got_re, got_im, meta = TC.load_state(path)
    np.testing.assert_array_equal(got_re, re)
    np.testing.assert_array_equal(got_im, im)
    assert meta == {"num_qubits": N, "dtype": str(re.dtype), "note": kind}


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_halves_round_trip(tmp_path, kind):
    parts = _halves(2)
    src = tuple(torch.from_numpy(p) for p in parts) if kind == "tensor" \
        else parts
    path = str(tmp_path / "h.npz")
    TC.save_state_halves(path, *src, N, meta={"circuit": "x.qasm"})
    got, meta = TC.load_state_halves(path)
    for g, p in zip(got, parts):
        np.testing.assert_array_equal(g, p)
    assert meta == {"num_qubits": N, "dtype": "float32", "layout": "halves",
                    "circuit": "x.qasm"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flat_files_cross_load(tmp_path, writer):
    re, im = _state(3)
    save, load = ((JC.save_state, TC.load_state) if writer == "jax"
                  else (TC.save_state, JC.load_state))
    path = str(tmp_path / "s.npz")
    save(path, re, im, N, meta={"strategy": "mxu"})
    got_re, got_im, meta = load(path)
    np.testing.assert_array_equal(got_re, re)
    np.testing.assert_array_equal(got_im, im)
    assert meta["strategy"] == "mxu" and meta["num_qubits"] == N
    with np.load(path) as z:
        assert sorted(z.files) == ["im", "meta", "re"]
        assert json.loads(str(z["meta"]))["dtype"] == "float32"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_halves_files_cross_load(tmp_path, writer):
    parts = _halves(4)
    save, load = ((JC.save_state_halves, TC.load_state_halves)
                  if writer == "jax" else
                  (TC.save_state_halves, JC.load_state_halves))
    path = str(tmp_path / "h.npz")
    save(path, *parts, N)
    got, meta = load(path)
    for g, p in zip(got, parts):
        np.testing.assert_array_equal(g, p)
    assert meta["layout"] == "halves"
    with np.load(path) as z:
        assert sorted(z.files) == ["im0", "im1", "meta", "re0", "re1"]


def test_halves_checkpoint_resumes_the_inplace_engine(tmp_path):
    """Run the first half of a circuit in place, checkpoint the halves,
    resume the second half from the file: the f64 reference of the whole
    circuit (1e-6, the "highest" bar)."""
    c = TM.grover_like(N, 300, 5)
    first = Circuit(N, list(c.gates[:150]))
    second = Circuit(N, list(c.gates[150:]))
    sim = Simulator(SimulatorConfig(strategy="prefetch",
                                    prefetch_inplace=True,
                                    precision="highest"), device="cpu")
    parts, _ = sim.run_device_halves(first)
    path = str(tmp_path / "mid.npz")
    TC.save_state_halves(path, *parts, N)
    loaded, meta = TC.load_state_halves(path)
    assert meta["num_qubits"] == N
    resumed, _ = sim.run_device_halves(second, initial_parts=loaded)
    got = join_state(*join_halves(*resumed))
    assert np.max(np.abs(got - simulate_reference(c))) < 1e-6


def test_shape_errors_as_in_jax(tmp_path):
    re, im = _state(5)
    path = str(tmp_path / "s.npz")
    for mod in (JC, TC):
        with pytest.raises(ValueError, match="do not match num_qubits"):
            mod.save_state(path, re, im, N + 1)
        with pytest.raises(ValueError, match=r"half shape \(4, 128\)"):
            mod.save_state_halves(path, *_halves(6), N + 1)
    TC.save_state(path, re, im, N)
    msgs = []
    for mod in (JC, TC):
        with pytest.raises(ValueError,
                           match="not a split-state checkpoint") as exc:
            mod.load_state_halves(path)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    # a meta record that disagrees with the arrays
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, re=re, im=im,
                        meta=json.dumps({"num_qubits": N + 1}))
    for mod in (JC, TC):
        with pytest.raises(ValueError, match="corrupt checkpoint"):
            mod.load_state(bad)


@pytest.mark.parametrize("fn", ["save_state_sharded", "load_state_sharded"])
def test_sharded_checkpoints_name_their_roadmap_item(tmp_path, fn):
    """The sharded checkpoints are ported: a state saved shard by shard
    (from the shard lists of a sharded run, or flat arrays as one shard)
    reloads bit for bit, as numpy arrays without a mesh and as shard lists
    onto a mesh of another shard count; a state that does not match
    num_qubits raises."""
    from gpu_quantum_simulator_tpu_torch.parallel.mesh import make_mesh

    re, im = _state(7)
    path = str(tmp_path / "d")
    if fn == "save_state_sharded":
        TC.save_state_sharded(path, re, im, N, meta={"step": 3})
        with pytest.raises(ValueError, match="do not match"):
            TC.save_state_sharded(str(tmp_path / "e"), re[:8], im[:8], N)
    else:
        shards = [torch.from_numpy(x) for x in np.split(re, 4)]
        TC.save_state_sharded(path, shards,
                              [torch.from_numpy(x) for x in np.split(im, 4)],
                              N, meta={"step": 3})
    got_re, got_im, meta = TC.load_state_sharded(path)
    assert np.array_equal(got_re, re) and np.array_equal(got_im, im)
    assert meta["num_qubits"] == N and meta["step"] == 3
    assert meta["dtype"] == "float32"
    for count in (1, 2, 8):
        mesh = make_mesh((count,), ("amp",), ["cpu"] * 8)
        sre, sim_, _ = TC.load_state_sharded(path, mesh=mesh)
        assert len(sre) == count and sre[0].shape == ((1 << N) // count,)
        assert np.array_equal(torch.cat(sre).numpy(), re)
        assert np.array_equal(torch.cat(sim_).numpy(), im)
