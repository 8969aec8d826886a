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
s = T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cpu").run(c)
assert s.shape == (1 << 10,) and abs(np.linalg.norm(s) - 1) < 1e-5
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
    assert len(files) > 15 and not bad, bad
