"""BENCHMARK.json keeps to its contract, and the harness finds every piece
by name, so that a new configuration, mix or metric needs no edit."""

import json
import os
import re

import pytest

from benchmark.harness import Spec, run_cell
from bench_support import ROOT, small_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_units_and_text():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(b["command"]) <= 32
    for word in b["command"]:
        assert TEXT.match(word)
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in b[group]]
        assert len(got) == len(set(got)), group
    roofline = [m for m in b["per_layer"] if "_roofline" in m["name"]]
    assert roofline and all(m["unit"] == "%" for m in roofline)


def test_every_cell_reports_what_it_must():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    assert {c["name"] for c in b["configs"]} == {w["config"]
                                                 for w in b["workloads"]}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    spec = Spec(ROOT)
    for cell in cells:
        e2e = [m["name"] for m, _ in spec.metrics(cell, traced=False)]
        layer = spec.metrics(cell, traced=True)
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert layer, cell
        for m, _ in layer:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", ())) <= cells
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(cells) // 4)


def test_config_files_state_their_deployment():
    b = _bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        for key in ("family", "reference", "num_qubits", "num_gates",
                    "structure_seed", "simulator", "precision", "limits",
                    "control", "assumed", "guarantees"):
            assert key in config, (c["name"], key)
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "families", config["family"] + ".py"))
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "references", config["reference"] + ".py"))
    sources = [c["source"] for c in b["configs"]]
    assert len(set(sources)) == len(sources)


NEW_ENTRY = '''"""Entry run_state: ``Simulator.run``, two circuits in turn."""
from benchmark import check


def traffic(cell, draw):
    return draw(0), [draw(1, 0), draw(1, 1)], []


def call(cell, circuit, i):
    return cell.sim.run(circuit)


def judge(cell, answers, kept, reference):
    errs = [check.amp_err(a, reference.simulate(
        cell.gates[i % 2], cell.n, device=cell.ref_device))
        for i, a in enumerate(answers)]
    return {"amp_err": max(errs)}, 0
'''

NEW_FAMILY = '''"""A ladder: h on every qubit, a cx chain, rz angles from the seed."""
import numpy as np


def gates(config, entropy):
    n, rng = config["num_qubits"], np.random.default_rng(list(entropy))
    out = [("h", (q,), ()) for q in range(n)]
    out += [("cx", (q, q + 1), ()) for q in range(n - 1)]
    return out + [("rz", (q,), (float(rng.uniform(-3, 3)),))
                  for q in range(n)]
'''


def _add(root, path, text):
    with open(os.path.join(root, "benchmark", path), "w") as f:
        f.write(text)


def test_additions_need_no_edit(tmp_path):
    """A configuration, a family, a mix with an entry of its own (its own
    call, traffic and judge) and a metric added as new files and new
    entries are found and run; no file of the benchmark is edited."""
    root = small_copy(tmp_path)
    before = _digest(os.path.join(root, "benchmark"))
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "configs", "grover2445-n28-mxu.json")) as f:
        config = json.load(f)
    config.update(name="ladder-n10-mxu", num_qubits=10, family="ladder")
    _add(root, "configs/ladder-n10-mxu.json", json.dumps(config))
    _add(root, "families/ladder.py", NEW_FAMILY)
    _add(root, "entries/run_state.py", NEW_ENTRY)
    _add(root, "mixes/states.json", json.dumps({"entry": "run_state"}))
    _add(root, "metrics/requests.again.py",
         "def read(run):\n    return len(run.requests)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "ladder-n10-mxu", "source": "test",
                         "file": "benchmark/configs/ladder-n10-mxu.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "ladder-n10-mxu.states",
                           "config": "ladder-n10-mxu", "traffic": "states",
                           "chips": 1, "why": "test"})
    b["end_to_end"][0].setdefault("workloads", []).append(
        "ladder-n10-mxu.states")
    b["per_layer"].append({"name": "requests.again", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "facade", "moves": "circuit_s",
                           "workloads": ["ladder-n10-mxu.states"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    spec = Spec(root)
    for traced, want in ((False, {"circuit_s", "setup_s"}),
                         (True, {"requests.again"})):
        result, checks = run_cell(spec, "ladder-n10-mxu.states", 5, 0.05,
                                  traced, "cpu", 0.0, log=lambda *a: None)
        assert result["correct"] and set(result["metrics"]) == want
        assert checks["amp_err"]["value"] < 1e-5
    assert result["metrics"]["requests.again"]["value"] >= 1
    assert result["breakdown"] and result["device"]["busy_s"] >= 0
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("traffic", ["amps", "shots"])
def test_a_four_chip_cell_is_data_only(tmp_path, traffic):
    """A cell at ``chips`` 4 runs its simulator on four devices (here four
    CPU devices, on the card cuda:0..3) through the same entries: a
    configuration file and a workload entry, no code."""
    root = small_copy(tmp_path)
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "configs", "grover2445-n28-mxu.json")) as f:
        config = json.load(f)
    config.update(name="grover2445-n12-sharded4",
                  simulator={"strategy": "sharded"})
    _add(root, "configs/grover2445-n12-sharded4.json", json.dumps(config))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "grover2445-n12-sharded4", "source": "test",
                         "file": "benchmark/configs/"
                                 "grover2445-n12-sharded4.json",
                         "reduced": [], "why": "test"})
    cell = "grover2445-n12-sharded4." + traffic
    b["workloads"].append({"name": cell, "config": "grover2445-n12-sharded4",
                           "traffic": traffic, "chips": 4, "why": "test"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["workloads"][0].endswith(traffic):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    result, checks = run_cell(Spec(root), cell, 7, 0.0, False, "cpu", 0.0,
                              log=lambda *a: None)
    assert result["correct"], checks
    assert result["device"]["count"] == 4
    assert checks["amp_err"]["value"] < 1e-5


def test_a_mix_draws_a_structure_a_request(tmp_path):
    """``mixes/rcs.json`` overrides the configuration's ``structure_seed``
    with null: every request's circuit is drawn whole from the seed, and a
    cell of it is a workload entry alone."""
    from benchmark.harness import Cell

    root = small_copy(tmp_path)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    cell = "grover2445-n28-mxu.rcs"
    b["workloads"].append({"name": cell, "config": "grover2445-n28-mxu",
                           "traffic": "rcs", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "shots_circuit_s":
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    spec = Spec(root)
    made = Cell(spec, cell, 2**31 + 7, "cpu")
    shapes = {tuple((g[0], g[1]) for g in gates) for gates in made.gates}
    assert len(shapes) == len(made.gates) == made.mix["prepared"]
    result, checks = run_cell(spec, cell, 2**31 + 7, 0.0, False, "cpu", 0.0,
                              log=lambda *a: None)
    assert result["correct"], checks


def test_a_mix_naming_an_entry_without_a_file_is_refused(tmp_path):
    """An unknown ``entry`` stops the run before any request: it never
    falls back to another entry."""
    root = small_copy(tmp_path)
    path = os.path.join(root, "benchmark", "mixes", "amps.json")
    with open(path) as f:
        mix = json.load(f)
    mix["entry"] = "run_elsewhere"
    with open(path, "w") as f:
        json.dump(mix, f)
    with pytest.raises(ValueError, match="run_elsewhere"):
        run_cell(Spec(root), "grover2445-n28-mxu.amps", 5, 0.0, False, "cpu",
                 0.0, log=lambda *a: None)


def _digest(directory):
    out = {}
    for dirpath, _, files in os.walk(directory):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, directory)] = fh.read()
    return out


@pytest.mark.chip
def test_a_cell_runs_on_the_card(tmp_path):
    """One short run of the first cell on the card: a result line, correct."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the benchmark runs only there")
    cell = _bench()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "11", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

