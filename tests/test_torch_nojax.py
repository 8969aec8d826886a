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
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    bad = {(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    rel = {os.path.relpath(f, PORT) for f in files}
    assert {"engine/wide.py", "engine/pallas_engine.py", "kernels/wide.py",
            "passes/shard.py", "utils/roofline.py", "engine/vmem.py",
            "kernels/vmem.py", "engine/megakernel.py", "kernels/split.py",
            "sampling.py", "ref/cpu.py", "ops/pallas_kernels.py",
            "kernels/copy.py", "dma_probe.py"} <= rel, rel
    assert len(files) > 15 and not bad, bad
