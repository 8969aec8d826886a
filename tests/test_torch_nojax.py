"""The port runs without JAX and never imports the JAX package."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gpu_quantum_simulator_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "gpu_quantum_simulator_tpu")

_PROBE = """
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import numpy as np
import gpu_quantum_simulator_tpu_torch as T
c = T.models.grover_like(10, 200, 1)
for strategy in ("prefetch", "mxu", "pallas", "vmem", "megakernel"):
    s = T.Simulator(T.SimulatorConfig(strategy=strategy), device="cpu").run(c)
    assert s.shape == (1 << 10,) and abs(np.linalg.norm(s) - 1) < 1e-5
s = T.Simulator(T.SimulatorConfig(strategy="mxu"), device="cpu").run(
    T.models.grover_like(5, 100, 1))
assert s.shape == (1 << 5,) and abs(np.linalg.norm(s) - 1) < 1e-5
from gpu_quantum_simulator_tpu_torch import sampling
sim = T.Simulator(T.SimulatorConfig(strategy="prefetch", prefetch_inplace=True),
                  device="cpu")
parts, _ = sim.run_device_halves(c)
assert abs(sampling.norm_halves(*parts) - 1) < 1e-5
assert sampling.sample_halves(*parts, 10, 50, 1).shape == (50,)
assert sim.sample(c, 50, seed=1).shape == (50,)
parts, _ = sim.run_device_halves(c, initial_parts=parts)
assert abs(sampling.norm_halves(*parts) - 1) < 1e-5
r = T.Simulator(T.SimulatorConfig(strategy="reference"), device="cpu").run(c)
assert r.shape == (1 << 10,) and abs(np.linalg.norm(r) - 1) < 1e-12
import torch
from gpu_quantum_simulator_tpu_torch import dma_probe
from gpu_quantum_simulator_tpu_torch.kernels import copy as KC
from gpu_quantum_simulator_tpu_torch.ops import pallas_kernels as PK
x = torch.ones(8, 128)
y = PK.apply_butterfly_high(x, x, np.eye(2), 2)
assert torch.equal(y[0], x) and torch.equal(y[1], x)
assert torch.equal(KC.hbm_direct([x, x], 2, 2)[1], x)
assert len(dma_probe.routes((x.repeat(64, 2),) * 2, (x.repeat(64, 2),) * 2))
sim = T.Simulator(T.SimulatorConfig(strategy="mxu"), device="cpu")
prefix, body, reps = T.models.grover_parts(5, 19)
re, im, _ = sim.run_device_iterated(body, reps, prefix=prefix)
assert int(torch.argmax(re * re + im * im)) == 19
re, im, _ = sim.run_device_parts(T.models.ghz(8), (re, im))
assert abs(T.norm_device(re, im) - 1) < 1e-5
terms = T.models.maxcut_cost_terms(8)
e = sim.run_many([T.models.qaoa_maxcut(8), T.models.ghz(8)], terms=terms)
assert e.shape == (2,) and abs(e[0] - T.expectation_pauli_sum(
    T.models.qaoa_maxcut(8), terms, device="cpu")) < 1e-5
u = T.circuit_unitary(T.Circuit(2).h(0).cx(0, 1))
assert np.allclose(T.circuit_unitary(T.Circuit(2).unitary(u, 0, 1)), u)
for strategy in ("naive", "fused2x2", "fused3in1", "fused4x4", "scan"):
    s = T.Simulator(T.SimulatorConfig(strategy=strategy), device="cpu").run(c)
    assert s.shape == (1 << 10,) and abs(np.linalg.norm(s) - 1) < 1e-5
import contextlib, io, os, tempfile
from gpu_quantum_simulator_tpu_torch.__main__ import main
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "c.qasm")
    with open(path, "w") as f:
        f.write(c.to_qasm())
    assert T.parse_qasm_file(path).num_qubits == 10
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main([path, "--device", "cpu", "--strategy", "scan",
                     "--amplitudes", "2", "--save-state",
                     os.path.join(d, "s.npz")]) == 0
    assert float(out.getvalue().splitlines()[0]) >= 0
g, _ = T.adjoint_gradient(T.models.random_circuit(5, 30, seed=2),
                          z_qubits=[0, 1], device="cpu")
assert g.shape[0] > 0 and np.all(np.isfinite(g))
dc = T.DynamicCircuit(3, num_clbits=1).h(0).cx(0, 1).measure(1, 0)
res = T.run_dynamic_batched(dc, shots=16, seed=1, device="cpu")
assert len(res) == 16 and {r.clbits for r in res} <= {(0,), (1,)}
nc = T.NoisyCircuit(5).h(0).cx(0, 1).channel("dephasing", 1, p=0.5)
rho = T.DensitySimulator(device="cpu").run(nc)
assert abs(rho.probabilities().sum() - 1) < 1e-5
bases, outs = T.shadow_snapshots(T.models.ghz(4), 64, seed=1, device="cpu")
assert bases.shape == (64, 4) and outs.shape == (64,)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "g.qasm")
    with open(path, "w") as f:
        f.write(T.models.ghz(4).to_qasm())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main([path, "--device", "cpu", "-m", "8", "--noise-p1",
                     "0.05", "--noise-readout", "0.01"]) == 0
    assert len(out.getvalue().splitlines()) == 9
for mesh in ((8,), (2,)):       # the dense and the segmented engine
    sim = T.Simulator(T.SimulatorConfig(strategy="sharded", mesh_shape=mesh),
                      device=["cpu"] * 8)
    s = sim.run(c)
    assert s.shape == (1 << 10,) and abs(np.linalg.norm(s) - 1) < 1e-5
    re, im, _ = sim.run_device(c)
    assert len(re) == mesh[0] and abs(T.norm_device(re, im) - 1) < 1e-5
    assert sampling.sample_state_device(re, im, 10, 50, 1).shape == (50,)
    with tempfile.TemporaryDirectory() as d:
        from gpu_quantum_simulator_tpu_torch.utils import checkpoint as CK
        CK.save_state_sharded(d, re, im, 10)
        assert np.allclose(CK.load_state_sharded(d)[0], s.real)
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "gpu_quantum_simulator_tpu"))]
print("LOADED", loaded)
"""


def test_port_runs_with_jax_unimportable():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "chip_mesh.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    bad = {(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    rel = {os.path.relpath(f, PORT) for f in files}
    assert {"engine/wide.py", "engine/pallas_engine.py", "kernels/wide.py",
            "passes/shard.py", "utils/roofline.py", "engine/vmem.py",
            "kernels/vmem.py", "engine/megakernel.py", "kernels/split.py",
            "sampling.py", "ref/cpu.py", "ops/pallas_kernels.py",
            "kernels/copy.py", "dma_probe.py", "observables.py",
            "ir/decompose.py", "engine/graphs.py",
            "models/circuits.py", "qasm/parser.py", "utils/checkpoint.py",
            "passes/fuse2x2.py", "engine/naive.py", "engine/scan.py",
            "__main__.py", "gradients.py", "dynamic.py", "density.py",
            "mitigation.py", "shadows.py", "mps.py", "ref/stabilizer.py",
            "interop.py", "parallel/mesh.py", "parallel/sharded.py",
            "parallel/sharded_prefetch.py"} <= rel, rel
    assert len(files) > 15 and not bad, bad
