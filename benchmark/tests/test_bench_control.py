"""``correct`` comes out false for the control and for each fault a cell can
have, and true for the program as the configuration states it.

At a size the CPU holds (n = 12, the port's plain versions of its kernels),
through the whole of a run but the look for a card: the same traffic, entry
points, capture and comparisons, and the limits the configurations state.
The control is the program on the rung below the one stated ("default", one
bf16 pass, for "high"); the faults are planted in the timed path."""

import json
import os

import numpy as np
import pytest

import gpu_quantum_simulator_tpu_torch as T
from benchmark.harness import Spec, run_cell
from bench_support import ROOT, small_copy

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    _CELLS = json.load(_f)["workloads"]
CELLS = [w["name"] for w in _CELLS]


def _entry(workload):
    with open(os.path.join(ROOT, "benchmark", "mixes",
                           workload["traffic"] + ".json")) as f:
        return json.load(f)["entry"]


AMPS = [w["name"] for w in _CELLS if _entry(w) == "run_detailed"]
SHOTS = [w["name"] for w in _CELLS if _entry(w) == "sample"]
SEED = 2147483659


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(small_copy(tmp_path_factory.mktemp("bench")))


def _run(spec, cell, overrides=None):
    return run_cell(spec, cell, SEED, 0.0, False, "cpu", 0.0,
                    overrides=overrides, log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_and_the_control_is_not(spec, cell):
    result, checks = _run(spec, cell)
    assert result["correct"], checks
    config = spec.config(spec.cell(cell)["config"])
    result, checks = _run(spec, cell, overrides=config["control"])
    assert not result["correct"]
    assert checks["amp_err"]["value"] > checks["amp_err"]["limit"]


def _skip_some(real):
    """``real`` with one call in five left out: the step returns its state
    unchanged, in the warm-up and in the window alike."""
    calls = []

    def fault(*a, **k):
        calls.append(1)
        if len(calls) % 5 == 3:
            return None
        return real(*a, **k)

    return fault


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged(spec, cell, monkeypatch):
    from gpu_quantum_simulator_tpu_torch.engine import prefetch, wide

    monkeypatch.setattr(wide, "_mm_step", _skip_some(wide._mm_step))
    monkeypatch.setattr(prefetch, "run_split_block",
                        _skip_some(prefetch.run_split_block))
    result, checks = _run(spec, cell)
    assert not result["correct"]
    assert checks["amp_err"]["value"] > checks["amp_err"]["limit"]


@pytest.mark.parametrize("cell", AMPS)
def test_an_amplitude_altered_where_it_is_made(spec, cell, monkeypatch):
    from gpu_quantum_simulator_tpu_torch.engine import simulator

    real = simulator._join

    def fault(re, im):
        out = real(re, im)
        out[77] += 0.1
        return out

    monkeypatch.setattr(simulator, "_join", fault)
    result, checks = _run(spec, cell)
    assert not result["correct"]
    assert checks["amp_err"]["value"] > checks["amp_err"]["limit"]


SHOT_FAULTS = {
    # every answer altered: the shots come from another distribution
    "altered": lambda s: s ^ 1,
    # half the batch of shots left out
    "half": lambda s: s[: len(s) // 2],
}


@pytest.mark.parametrize("fault", sorted(SHOT_FAULTS))
@pytest.mark.parametrize("cell", SHOTS)
def test_shots_altered_or_left_out(spec, cell, fault, monkeypatch):
    real = T.Simulator.sample

    def sample(self, *a, **k):
        return SHOT_FAULTS[fault](np.asarray(real(self, *a, **k)))

    monkeypatch.setattr(T.Simulator, "sample", sample)
    result, checks = _run(spec, cell)
    assert not result["correct"]
    name = "shots_z" if fault == "altered" else "shots_bad"
    assert checks[name]["value"] > checks[name]["limit"]
