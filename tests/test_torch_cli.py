"""The port's CLI against the JAX package's, in process, ``--device cpu``
on both, on the same QASM files: every line but the seconds equal as text,
or as numbers within 1e-6 where a line prints amplitudes, expectations,
marginals, entropies or a norm."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from gpu_quantum_simulator_tpu.__main__ import main as jax_main
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.__main__ import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _call(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    return rc, out.getvalue(), err.getvalue()


def _same_line(a, b):
    if a == b:
        return True
    if _NUM.sub("#", a) != _NUM.sub("#", b):
        return False
    x = [float(v) for v in _NUM.findall(a)]
    y = [float(v) for v in _NUM.findall(b)]
    return np.allclose(x, y, rtol=0, atol=TOL)


def _compare(port, jax):
    """Equal exit codes and stderr; stdout equal line by line after the
    seconds (or the JSON record, compared without its seconds)."""
    assert port[0] == jax[0], (port, jax)
    assert port[2] == jax[2]
    p_lines, j_lines = port[1].splitlines(), jax[1].splitlines()
    assert len(p_lines) == len(j_lines), (port[1], jax[1])
    if not p_lines:
        return p_lines
    if p_lines[0].startswith("{"):
        p_rec, j_rec = json.loads(p_lines[0]), json.loads(j_lines[0])
        assert p_rec.pop("seconds") >= 0 and "seconds" in j_rec
        j_rec.pop("seconds")
        p_norm, j_norm = p_rec.pop("norm", 1.0), j_rec.pop("norm", 1.0)
        assert abs(p_norm - j_norm) < TOL and p_rec == j_rec
    else:
        float(p_lines[0])
        float(j_lines[0])
    for a, b in zip(p_lines[1:], j_lines[1:]):
        assert _same_line(a, b), (a, b)
    return p_lines


def _both(*args):
    args = [*args, "--device", "cpu"]
    return _compare(_call(port_main, args), _call(jax_main, args))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qasm")
    out = {}
    for name, c in (("rand", TM.quantum_volume(7, depth=3, seed=2)),
                    ("ghz", TM.ghz(6)), ("ghz10", TM.ghz(10)),
                    ("xlayer", _x_layer(10))):
        path = d / f"{name}.qasm"
        path.write_text(c.to_qasm())
        out[name] = str(path)
    out["dir"] = str(d)
    return out


def _x_layer(n):
    c = TM.ghz(n)
    c.gates.clear()
    for q in range(n):
        c.x(q)
    return c


@pytest.mark.parametrize("flags", [
    ("--json",),
    ("--amplitudes", "4"),
    ("--expectation", "Z0 Z1", "--expectation", "X2 Y3 Z6"),
    ("--marginal", "0,3", "--marginal", "5", "--entropy-cut", "3"),
    ("--strategy", "naive", "--amplitudes", "3"),
    ("--strategy", "fused2x2", "--amplitudes", "3"),
    ("--strategy", "fused3in1", "--amplitudes", "3"),
    ("--strategy", "fused4x4", "--amplitudes", "3", "--json"),
    ("--strategy", "scan", "--amplitudes", "3", "--json"),
    ("--strategy", "megakernel", "--permute", "--amplitudes", "3"),
    ("--strategy", "reference", "--amplitudes", "3"),
    ("--precision", "highest", "--amplitudes", "3"),
], ids=lambda f: "_".join(x.strip("-").replace(" ", "") for x in f))
def test_flat_outputs_match_jax(files, flags):
    lines = _both(files["rand"], *flags)
    assert len(lines) >= 1


def test_measurements_match_on_ghz(files):
    lines = _both(files["ghz"], "-m", "25", "--seed", "3")
    meas = [l for l in lines if l.startswith("MEASUREMENT:")]
    assert len(meas) == 25
    assert {m.split()[1] for m in meas} == {"000000", "111111"}


def test_flat_checkpoints_match_and_resume(files, tmp_path):
    """--save-state files written by both packages hold the same state;
    --load-state resumes in each from the other's file."""
    p_ck, j_ck = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    _compare(_call(port_main, [files["rand"], "--device", "cpu",
                               "--save-state", p_ck]),
             _call(jax_main, [files["rand"], "--device", "cpu",
                              "--save-state", j_ck]))
    with np.load(p_ck) as p, np.load(j_ck) as j:
        assert sorted(p.files) == sorted(j.files) == ["im", "meta", "re"]
        assert np.max(np.abs(p["re"] - j["re"])) < TOL
        assert json.loads(str(p["meta"])) == json.loads(str(j["meta"])) \
            | {"circuit": files["rand"]}
    _compare(_call(port_main, [files["rand"], "--device", "cpu",
                               "--load-state", j_ck, "--amplitudes", "3"]),
             _call(jax_main, [files["rand"], "--device", "cpu",
                              "--load-state", p_ck, "--amplitudes", "3"]))
    rc, _, err = _call(port_main, [files["ghz"], "--device", "cpu",
                                   "--load-state", p_ck])
    assert rc == 1 and "checkpoint has 7 qubits, circuit has 6" in err


def test_inplace_route_with_halves_checkpoints(files, tmp_path):
    """--inplace: the split-state outputs, a halves checkpoint written and
    resumed (X^n maps GHZ onto itself), as the JAX package's CLI."""
    lines = _both(files["ghz10"], "--strategy", "prefetch", "--inplace",
                  "--json", "--amplitudes", "2", "--marginal", "0,1",
                  "--entropy-cut", "2")
    assert json.loads(lines[0])["split_state"] is True
    # samples of the halves come from each package's device generator
    # (torch's, jax.random), so they agree in law, not draw for draw
    rc, out, _ = _call(port_main, [files["ghz10"], "--device", "cpu",
                                   "--strategy", "prefetch", "--inplace",
                                   "-m", "40", "--seed", "1"])
    meas = [l.split()[1] for l in out.splitlines()
            if l.startswith("MEASUREMENT:")]
    assert rc == 0 and len(meas) == 40 and set(meas) == {"0" * 10, "1" * 10}
    ck = str(tmp_path / "halves.npz")
    _call(port_main, [files["ghz10"], "--device", "cpu", "--strategy",
                      "prefetch", "--inplace", "--save-state", ck])
    with np.load(ck) as z:
        assert "re0" in z.files and json.loads(str(z["meta"]))["layout"] \
            == "halves"
    lines = _both(files["xlayer"], "--strategy", "prefetch", "--inplace",
                  "--load-state", ck, "--amplitudes", "2")
    tops = {l.split(">")[0][1:]: float(l.split("p=")[1].split()[0])
            for l in lines if l.startswith("|")}
    assert abs(tops["0" * 10] - 0.5) < 1e-4 and abs(tops["1" * 10] - 0.5) < 1e-4
    # a flat checkpoint is refused by the halves route, as in JAX
    flat = str(tmp_path / "flat.npz")
    _call(port_main, [files["ghz10"], "--device", "cpu", "--save-state", flat])
    rc, _, err = _call(port_main, [files["xlayer"], "--device", "cpu",
                                   "--strategy", "prefetch", "--inplace",
                                   "--load-state", flat])
    assert rc == 1 and "not a split-state checkpoint" in err
    # too small a width for the in-place engine
    rc, _, err = _call(port_main, [files["ghz"], "--device", "cpu",
                                   "--strategy", "prefetch", "--inplace"])
    assert rc == 1 and err.startswith("ERROR: ")


@pytest.mark.parametrize("case", [
    "parse_error", "noise_without_m", "noise_with_amplitudes",
    "noise_with_expectation", "noise_with_save_state",
    "noise_with_load_state", "readout_noise_without_m",
    "bad_pauli", "marginal_out_of_range", "entropy_cut_out_of_range"])
def test_error_paths_match_jax(files, case):
    f = files["ghz"]
    noisy = [f, "-m", "5", "--noise-p2", "0.1"]
    args = {"parse_error": [os.path.join(files["dir"], "missing.qasm")],
            "noise_without_m": [f, "--noise-p1", "0.1"],
            "noise_with_amplitudes": [f, "-m", "5", "--noise-p1", "0.1",
                                      "--amplitudes", "2"],
            "noise_with_expectation": [*noisy, "--expectation", "Z0"],
            "noise_with_save_state": [*noisy, "--save-state",
                                      os.path.join(files["dir"], "s.npz")],
            "noise_with_load_state": [*noisy, "--load-state",
                                      os.path.join(files["dir"], "s.npz")],
            "readout_noise_without_m": [f, "--noise-readout", "0.1"],
            "bad_pauli": [f, "--expectation", "QQ"],
            "marginal_out_of_range": [f, "--marginal", "7"],
            "entropy_cut_out_of_range": [f, "--entropy-cut", "6"]}[case]
    _both(*args)
    rc, _, err = _call(port_main, [*args, "--device", "cpu"])
    assert rc == 1 and "ERROR" in err


def test_port_only_errors(files, monkeypatch, tmp_path):
    """What the port once refused runs now, and the CLI's result is the
    Simulator's bit for bit: complex128 (its noise route too, with
    ``sample_noisy``'s outcomes) and the "default" rung.  The card asked
    for on a host without one is still an ERROR line and exit 1, by either
    route."""
    import torch

    from gpu_quantum_simulator_tpu_torch import Simulator, SimulatorConfig
    from gpu_quantum_simulator_tpu_torch.dynamic import sample_noisy
    from gpu_quantum_simulator_tpu_torch.qasm.parser import parse_qasm_file
    from gpu_quantum_simulator_tpu_torch.utils.checkpoint import load_state

    # n = 10: the megakernel arm of n <= 7 ignores the rung
    circuit = parse_qasm_file(files["ghz10"])
    ck = str(tmp_path / "state.npz")
    for args, kw in ((["--dtype", "complex128"], dict(dtype="complex128")),
                     (["--precision", "default"], dict(precision="default"))):
        rc, _, err = _call(port_main, [files["ghz10"], "--device", "cpu",
                                       "--save-state", ck, *args])
        assert rc == 0 and err == "", err
        re, im, _ = load_state(ck)
        want = Simulator(SimulatorConfig(**kw), device="cpu").run(circuit)
        assert re.dtype == want.real.dtype
        assert np.array_equal(re, want.real) and np.array_equal(im, want.imag)
    rc, out, err = _call(port_main, [files["ghz10"], "--device", "cpu", "-m",
                                     "5", "--noise-p1", "0.1", "--dtype",
                                     "complex128"])
    assert rc == 0 and err == "", err
    want = sample_noisy(circuit, 5, kind="depolarizing", p1=0.1, seed=0,
                        config=SimulatorConfig(dtype="complex128"),
                        device="cpu")
    assert [line.split()[-1] for line in out.splitlines()[1:]] == \
        [f"({int(o)})" for o in want]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _call(port_main, [files["ghz"], "--device", "cuda"])
    assert rc == 1 and out == "" and "cuda" in err
    rc, out, err = _call(port_main, [files["ghz"], "--device", "cuda",
                                     "-m", "5", "--noise-p1", "0.1"])
    assert rc == 1 and out == "" and err.startswith("ERROR: ") \
        and "cuda" in err


NOISE_SHOTS = 2048


def _noise_counts(lines, n):
    meas = [l for l in lines if l.startswith("MEASUREMENT:")]
    for m in meas:
        bits, idx = m.split()[1], int(m.split()[2].strip("()"))
        assert len(bits) == n and int(bits, 2) == idx
    return np.bincount([int(m.split()[2].strip("()")) for m in meas],
                       minlength=1 << n) / max(len(meas), 1)


@pytest.mark.parametrize("flags", [
    ("--noise-p1", "0.05", "--noise-p2", "0.1"),
    ("--noise-p1", "0.05", "--noise-p2", "0.1", "--json"),
    ("--noise-p2", "0.2", "--noise-correlated", "--json"),
    ("--noise-kind", "dephasing", "--noise-p1", "0.3", "--seed", "4"),
    ("--noise-p1", "0.02", "--noise-readout", "0.05", "--json"),
], ids=lambda f: "_".join(x.strip("-") for x in f))
def test_noise_route_matches_jax(files, flags):
    """Every line but the seconds and the counts equal; the counts held to
    the JAX package's within 6 standard errors of the difference (the two
    packages draw different trajectories from one seed)."""
    args = [files["ghz"], "-m", str(NOISE_SHOTS), *flags, "--device", "cpu"]
    port, jax = _call(port_main, args), _call(jax_main, args)
    assert port[0] == jax[0] == 0 and port[2] == jax[2] == ""
    p_lines, j_lines = port[1].splitlines(), jax[1].splitlines()
    assert len(p_lines) == len(j_lines) == NOISE_SHOTS + 1
    if "--json" in flags:
        p_rec, j_rec = json.loads(p_lines[0]), json.loads(j_lines[0])
        assert p_rec.pop("seconds") >= 0
        j_rec.pop("seconds")
        assert p_rec == j_rec
    else:
        assert float(p_lines[0]) >= 0 and float(j_lines[0]) >= 0
    got, want = _noise_counts(p_lines, 6), _noise_counts(j_lines, 6)
    sigma = np.sqrt(np.maximum(want * (1 - want), 1.0 / NOISE_SHOTS)
                    / NOISE_SHOTS)
    assert np.all(np.abs(got - want) < 6 * np.sqrt(2) * sigma)


def test_noise_route_counts_match_density(files):
    """The noisy counts against the exact distribution: the density
    matrix of the same per-gate depolarizing model, within 4 standard
    errors."""
    from gpu_quantum_simulator_tpu_torch import density as TD
    from gpu_quantum_simulator_tpu_torch import dynamic as TY

    rc, out, _ = _call(port_main, [files["ghz"], "-m", str(NOISE_SHOTS),
                                   "--noise-p1", "0.05", "--noise-p2", "0.1",
                                   "--seed", "2", "--device", "cpu"])
    assert rc == 0
    got = _noise_counts(out.splitlines(), 6)
    nc = TD.NoisyCircuit(6)
    for item in TY.with_noise(TM.ghz(6), p1=0.05, p2=0.1).items:
        if isinstance(item, TY.Noise):
            nc.channel("depolarizing", item.qubit, p=item.p)
        else:
            nc.items.append(item)
    exact = TD.DensitySimulator(device="cpu").run(nc).probabilities()
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1.0 / NOISE_SHOTS)
                    / NOISE_SHOTS)
    assert np.all(np.abs(got - exact) < 4 * sigma)


def test_trace_writes_a_chrome_trace(files, tmp_path):
    d = str(tmp_path / "trace")
    rc, out, _ = _call(port_main, [files["ghz"], "--device", "cpu",
                                   "--trace", d])
    assert rc == 0 and float(out.splitlines()[0]) >= 0
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_module_entry_point(files):
    """``python -m gpu_quantum_simulator_tpu_torch``: one float first with
    --device cpu; without --device on a host with no card, a non-zero exit
    naming the card (no fallback to the CPU)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, "-m", "gpu_quantum_simulator_tpu_torch",
           files["ghz"]]
    ok = subprocess.run(cmd + ["--device", "cpu", "--amplitudes", "2"],
                        cwd=REPO, env=env, capture_output=True, text=True,
                        timeout=300)
    assert ok.returncode == 0, ok.stderr
    lines = ok.stdout.splitlines()
    assert float(lines[0]) >= 0 and "|000000>" in ok.stdout
    bad = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode == 1 and bad.stdout == ""
    assert "ERROR: device='cuda'" in bad.stderr
