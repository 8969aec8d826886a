"""What a run refuses, and what it never imports."""

import json
import os
import shutil
import subprocess
import sys

from bench_support import ROOT

CELL = "grover2445-n28-mxu.amps"


def _run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={**os.environ, **(env or {})})


def _no_result(out):
    for line in out.stdout.strip().splitlines():
        try:
            assert "correct" not in json.loads(line)
        except ValueError:
            pass


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run(ROOT, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2, out.stderr[-2000:]
    assert "CUDA card" in out.stderr
    _no_result(out)


def test_a_run_beside_no_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)


_PROBE = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from bench_support import small_copy
from benchmark import harness
root = small_copy({tmp!r})
spec = harness.Spec(root)
for cell in {cells!r}:
    for traced in (False, True):
        harness.run_cell(spec, cell, 3, 0.0, traced, "cpu", 0.0,
                         log=lambda *a: None)
import benchmark.run
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_REF_PROBE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location(
    "ref", {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.simulate([("sx", (0,), ()), ("cx", (0, 1), ())], 2)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))


def test_runs_import_no_jax_and_no_jax_package(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    names = _top_level(_PROBE.format(
        root=ROOT, tests=os.path.dirname(__file__), tmp=str(tmp_path),
        cells=cells))
    assert "gpu_quantum_simulator_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "gpu_quantum_simulator_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(ROOT, "benchmark", "references", "statevector.py")
    names = _top_level(_REF_PROBE.format(path=path))
    assert not names & {"jax", "jaxlib", "flax", "gpu_quantum_simulator_tpu",
                        "gpu_quantum_simulator_tpu_torch", "benchmark"}


_LEAK_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
sys.path.insert(0, {stubs!r})
from bench_support import small_copy
from benchmark import harness
root = small_copy({tmp!r})
with open(root + "/benchmark/metrics/leak.py", "w") as f:
    f.write("def read(run):\\n    import jax\\n    return 1.0\\n")
with open(root + "/BENCHMARK.json") as f:
    b = json.load(f)
b["per_layer"].append({{"name": "leak", "unit": "s", "better": "lower",
                       "source": "host_clock", "layer": "facade",
                       "moves": "circuit_s",
                       "workloads": ["grover2445-n28-mxu.amps"]}})
with open(root + "/BENCHMARK.json", "w") as f:
    json.dump(b, f)
result, _ = harness.run_cell(harness.Spec(root), "grover2445-n28-mxu.amps",
                             3, 0.0, True, "cpu", 0.0, log=lambda *a: None)
print(json.dumps(result))
"""


def test_a_module_of_jax_loaded_after_the_window_stops_the_result(tmp_path):
    """A per-layer reader (run after the window and the reference) that
    loads a module named ``jax``: the run names it and exits non-zero, and
    no result line comes out."""
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    (stubs / "jax.py").write_text("STUB = True\n")
    (tmp_path / "copy").mkdir()
    out = subprocess.run(
        [sys.executable, "-c", _LEAK_PROBE.format(
            root=ROOT, tests=os.path.dirname(__file__), stubs=str(stubs),
            tmp=str(tmp_path / "copy"))],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode != 0
    assert "jax" in out.stderr.splitlines()[-1]
    _no_result(out)
    assert out.stdout.strip() == ""
