"""A copy of the benchmark whose configurations are cut to a CPU's size."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT = "gpu_quantum_simulator_tpu_torch"
SMALL = {
    # the in-place engine runs from n = 9 when asked to, as at n = 30
    "grover2445-n30-inplace": {"strategy": "prefetch",
                               "prefetch_inplace": True,
                               "precision": "high"},
    # "auto" resolves to "high" from n = 24 only
    "grover2445-n28-mxu": {"precision": "high"},
}


def small_copy(dst, num_qubits=12):
    """``BENCHMARK.json`` and ``benchmark/`` copied under ``dst`` with
    every configuration at ``num_qubits`` and the rung it states; the port
    is linked in.  Returns the new root."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, PORT), os.path.join(dst, PORT))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        path = os.path.join(dst, entry["file"])
        with open(path) as f:
            config = json.load(f)
        config["num_qubits"] = num_qubits
        config["simulator"] = SMALL.get(entry["name"], config["simulator"])
        with open(path, "w") as f:
            json.dump(config, f)
    return str(dst)
