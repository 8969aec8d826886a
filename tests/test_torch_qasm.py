"""The port's QASM front-end and native parser/sampler against the JAX
package's: the same texts give the same gates (names, qubits, params
equal) and the same errors, and the native sampler draws the same
outcomes for the same seed."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu.qasm import parser as JP
from gpu_quantum_simulator_tpu.ref import native as JN
from gpu_quantum_simulator_tpu_torch.qasm import parser as TP
from gpu_quantum_simulator_tpu_torch.ref import native as TN
from gpu_quantum_simulator_tpu_torch import models as TM

CORPUS = {
    "qasm3_stdgates": (
        'OPENQASM 3.0;\ninclude "stdgates.inc";\nqubit[4] q;\n'
        "h q[0]; x q[1]; y q[2]; z q[3]; s q[0]; sdg q[1]; t q[2]; "
        "tdg q[3]; sx q[0]; sxdg q[1]; id q[2];\n"
        "rx(0.3) q[0]; ry(-0.7) q[1]; rz(1.25) q[2]; p(0.4) q[3];\n"
        "u(0.1, 0.2, 0.3) q[0]; cx q[0], q[3];\n"),
    "qubit_decl_suffix": "OPENQASM 3.0;\nqubit q[2];\nh q[0];\ncx q[0], q[1];\n",
    "qreg_comments": (
        "// a comment\nOPENQASM 2.0;\nqreg q[3];\nh q[0]; // trailing\n"
        "barrier q[0];\ncx q[0] , q[2] ;\ncreg c[3];\nmeasure q[0] -> c[0];\n"),
    "expressions": (
        "qubit[2] q;\nrz(pi/2) q[0]; rz(-3*pi/4) q[1]; rz((pi+1)/2) q[0];\n"
        "rz(--2) q[1]; rz(1+2*3) q[0]; rz(.5) q[1]; rz(2e-3) q[0];\n"
        "rz(8/2/2) q[1]; rz(tau/4) q[0]; rz(-(-(e))) q[1];\n"),
    "composites": (
        'OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[3];\nh q[0];\n'
        "crz(pi/3) q[0],q[1];\ncu1(0.25) q[1],q[2];\nrzz(pi/7) q[0],q[2];\n"
        "cy q[2],q[0];\nu2(0.1,0.2) q[1];\nu3(0.3,0.4,0.5) q[2];\n"
        "ccx q[0],q[1],q[2];\ncswap q[2],q[0],q[1];\nswap q[0],q[2];\n"
        "cz q[1],q[0];\nch q[0],q[2];\nrxx(0.9) q[0],q[1];\ncp(0.2) q[1],q[2];\n"),
    "user_gates": (
        "OPENQASM 2.0;\n"
        "gate majority a,b,c { cx c,b; cx c,a; ccx a,b,c; }\n"
        "gate phased(theta) a { h a; rz(theta/2) a; h a; }\n"
        "qreg q[3];\nx q[0];\nmajority q[0],q[1],q[2];\nphased(pi/2) q[1];\n"),
    "user_gates_nest_shadow": (
        "OPENQASM 2.0;\ngate myu1(lambda) q { rz(lambda) q; }\n"
        "gate mycp(lambda) a,b { myu1(lambda/2) a; cx a,b; "
        "myu1(-lambda/2) b; cx a,b; myu1(lambda/2) b; }\n"
        "gate cz a,b { mycp(pi) a,b; }\nqreg q[2];\nh q[0]; h q[1];\n"
        "cz q[0],q[1];\n"),
    "qelib1_style": (
        "OPENQASM 2.0;\n"
        "gate myu3(theta,phi,lambda) q { U(theta,phi,lambda) q; }\n"
        "gate myrx(theta) a { myu3(theta,-pi/2,pi/2) a; }\n"
        "gate mycnot c,t { CX c,t; }\nqreg q[2];\nmyrx(0.37) q[0];\n"
        "mycnot q[0],q[1];\n"),
    "broadcast": "OPENQASM 2.0;\nqreg q[3];\nh q;\nrz(pi/8) q;\nx q[1];\n",
    "for_loop": ("OPENQASM 3;\nqubit[5] q;\nh q[0];\n"
                 "for uint i in [0:3] { cx q[i], q[i+1]; }\n"),
    "inputs_consts_nesting": (
        "OPENQASM 3;\ninput float theta;\nconst uint n = 4;\nqubit[4] q;\n"
        "for uint i in [0:n-1] { rz(theta*i) q[i]; }\n"
        "for uint i in [0:2:n-2] { for uint j in {1, 3} { cx q[i], q[j]; } }\n"),
    "descending_range": ("OPENQASM 3;\nqubit[3] q;\n"
                         "for int i in [2:-1:0] { h q[i]; }\n"),
    "modifiers": (
        "OPENQASM 3.0;\nqubit[3] q;\nctrl @ x q[0], q[1];\n"
        "ctrl @ rz(0.7) q[0], q[1];\nnegctrl @ x q[1], q[0];\n"
        "ctrl(2) @ x q[0], q[1], q[2];\nctrl @ ctrl @ x q[0], q[1], q[2];\n"
        "inv @ s q[0];\npow(3) @ t q[1];\npow(0.5) @ x q[2];\n"
        "inv @ swap q[0], q[1];\nctrl @ u(0.5, 1.2, -0.9) q[2], q[0];\n"),
    "gphase": ("OPENQASM 3.0;\nqubit[2] q;\ngphase(0.7);\n"
               "ctrl @ gphase(0.7) q[0];\nnegctrl(2) @ gphase(0.3) q[0], q[1];\n"
               "inv @ gphase(0.2);\n"),
    "precounted": "3 4\nh q[0];\ncx q[0], q[1];\nrz(0.5) q[2];\nsx q[1];\nx q[0];\n",
    "reference_gate_set": (
        "OPENQASM 3.0;\nqubit[3] q;\nh q[0]; cx q[0], q[1]; x q[2]; sx q[1];\n"
        "z q[0]; s q[1]; sdg q[2]; t q[0]; tdg q[1]; rz(0.125) q[2];\n"
        "rz(-pi/4) q[0]; id q[1]; cx q[2], q[0];\n"),
}

INPUTS = {"inputs_consts_nesting": {"theta": 0.25}}

MALFORMED = {
    "gate_before_register": "h q[0];",
    "unknown_gate": "qubit[2] q; foo q[0];",
    "out_of_range": "qubit[2] q; cx q[0], q[5];",
    "control_is_target": "qubit[2] q; cx q[1], q[1];",
    "unknown_register": "qubit[2] q; h r[0];",
    "no_register": "OPENQASM 3.0;\n",
    "two_registers": "qubit[2] q; qubit[2] r;",
    "opaque": "OPENQASM 2.0;\nopaque magic a,b;\nqreg q[2];\n",
    "recursion": "OPENQASM 2.0;\ngate loop a { loop a; }\nqreg q[1];\nloop q[0];\n",
    "bad_param": "qubit[1] q; rz(2**3) q[0];",
    "param_division_by_zero": "qubit[1] q; rz(pi/0) q[0];",
    "fractional_pow_multi": "OPENQASM 3.0; qubit[2] q; pow(0.5) @ cx q[0], q[1];",
    "ctrl_overlap": "OPENQASM 3.0; qubit[2] q; ctrl @ x q[0], q[0];",
    "inv_with_argument": "OPENQASM 3.0; qubit[2] q; inv(2) @ x q[0];",
    "missing_input": "OPENQASM 3;\ninput float t;\nqubit[1] q;\nrz(t) q[0];\n",
    "zero_loop_step": "OPENQASM 3;\nqubit[2] q;\nfor int i in [0:0:1] { h q[0]; }\n",
    "unbalanced_braces": "OPENQASM 3;\nqubit[2] q;\nfor int i in [0:1] { h q[0];\n",
    "gphase_operands": "OPENQASM 3.0; qubit[2] q; ctrl(2) @ gphase(0.7) q[0];",
}


def _gates(c):
    return [(g.name, tuple(g.qubits), tuple(float(p) for p in g.params))
            for g in c.gates]


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_parse_matches_the_jax_parser(name):
    inputs = INPUTS.get(name)
    want = JP.parse_qasm(CORPUS[name], inputs=inputs)
    got = TP.parse_qasm(CORPUS[name], inputs=inputs)
    assert got.num_qubits == want.num_qubits
    assert _gates(got) == _gates(want) and len(got.gates) > 0


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_text_raises_the_jax_message(name):
    with pytest.raises(JP.QasmError) as jax_exc:
        JP.parse_qasm(MALFORMED[name])
    with pytest.raises(TP.QasmError) as port_exc:
        TP.parse_qasm(MALFORMED[name])
    assert isinstance(port_exc.value, ValueError)
    assert str(port_exc.value) == str(jax_exc.value)


def test_parse_file_and_roundtrip(tmp_path):
    """parse_qasm_file on a to_qasm() file: the circuit comes back gate for
    gate (repr floats round-trip), as the JAX package's does."""
    c = TM.grover_like(8, 300, 7)
    path = tmp_path / "c.qasm"
    path.write_text(c.to_qasm())
    got = TP.parse_qasm_file(str(path))
    assert _gates(got) == _gates(JP.parse_qasm_file(str(path)))
    assert _gates(got) == _gates(c)
    with pytest.raises(OSError):
        TP.parse_qasm_file(str(tmp_path / "missing.qasm"))


@pytest.mark.parametrize("name", sorted(set(CORPUS) - set(INPUTS)))
def test_native_parser_matches(name):
    """The port's native parser gives the JAX build's circuit or its
    error, and where it parses, the port's Python parser's gates (the
    native parser takes no ``inputs``)."""
    text = CORPUS[name]
    try:
        want = JN.parse_qasm_native(text)
    except ValueError as exc:
        with pytest.raises(ValueError) as port_exc:
            TN.parse_qasm_native(text)
        assert str(port_exc.value) == str(exc)
        return
    got = TN.parse_qasm_native(text)
    assert got.num_qubits == want.num_qubits
    assert _gates(got) == _gates(want)
    py = TP.parse_qasm(text)
    assert [g[:2] for g in _gates(got)] == [g[:2] for g in _gates(py)]
    np.testing.assert_allclose(
        [p for g in _gates(got) for p in g[2]],
        [p for g in _gates(py) for p in g[2]], atol=1e-12)


def test_native_parser_file_and_simulate_on_a_path(tmp_path):
    c = TM.grover_like(7, 400, 11)
    path = tmp_path / "g.qasm"
    path.write_text(c.to_qasm())
    got = TN.parse_qasm_native(str(path), is_path=True)
    assert _gates(got) == _gates(JN.parse_qasm_native(str(path), is_path=True))
    v_path = TN.simulate_native(str(path))
    np.testing.assert_array_equal(v_path, TN.simulate_native(c))
    np.testing.assert_array_equal(v_path, JN.simulate_native(str(path)))
    with pytest.raises(ValueError, match="cannot open"):
        TN.parse_qasm_native(str(tmp_path / "no.qasm"), is_path=True)
    assert TN.available() and TN._OPCODES == JN._OPCODES


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_native_equals_the_jax_build(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=256) + 1j * rng.normal(size=256)
    v /= np.linalg.norm(v)
    got = TN.sample_native(v, 3000, seed=seed)
    np.testing.assert_array_equal(got, JN.sample_native(v, 3000, seed=seed))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 256


def _dyn_items(dc):
    out = []
    for i in dc.items:
        kind = type(i).__name__
        if kind == "Gate":
            out.append((kind, i.name, i.qubits, tuple(i.params)))
        elif kind == "CondGate":
            out.append((kind, i.gate.name, i.gate.qubits,
                        tuple(i.gate.params), i.clbit, i.value))
        else:
            out.append((kind,) + tuple(vars(i).values()))
    return dc.num_qubits, dc.num_clbits, out


DYNAMIC_CORPUS = {
    "qasm3": ("OPENQASM 3.0; qubit[1] q; bit[1] c; "
              "c[0] = measure q[0];"),
    "teleport": (
        'OPENQASM 3.0;\ninclude "stdgates.inc";\nqubit[3] q;\nbit[2] c;\n'
        "rz(1.234) q[0]; sx q[0]; h q[1]; cx q[1], q[2]; cx q[0], q[1];\n"
        "h q[0]; c[0] = measure q[0]; c[1] = measure q[1];\n"
        "if (c[1] == 1) x q[2];\nif (c[0]) z q[2];\nreset q[0];\n"),
    "qasm2": ("OPENQASM 2.0;\nqreg q[2];\ncreg c[2];\nh q[0];\n"
              "measure q[0] -> c[0];\nif (c[0] == 0) rx(pi/3) q[1];\n"
              "measure q -> c;\nreset q;\n"),
    "one_bit_register": ("OPENQASM 3.0; qubit[2] q; bit[1] c; h q[0];\n"
                         "c[0] = measure q[0]; if (c == 1) cz q[0], q[1];\n"
                         "c[0] = measure q[1];"),
    "gate_def_and_loop": (
        "OPENQASM 3.0; qubit[3] q; bit[3] c;\n"
        "gate bell a, b { h a; cx a, b; }\n"
        "for int i in [0:1] { bell q[i], q[i+1]; }\n"
        "c = measure q;"),
}


@pytest.mark.parametrize("name", sorted(DYNAMIC_CORPUS))
def test_dynamic_parse_matches_jax(name):
    text = DYNAMIC_CORPUS[name]
    got = TP.parse_qasm_dynamic(text)
    assert type(got).__module__ == "gpu_quantum_simulator_tpu_torch.dynamic"
    assert _dyn_items(got) == _dyn_items(JP.parse_qasm_dynamic(text))


@pytest.mark.parametrize("text", [
    "OPENQASM 3.0; bit[1] c; h q[0];",
    "OPENQASM 3.0; qubit[1] q; bit c; h q[0];",
    "OPENQASM 3.0; qubit[1] q; bit[1] c; bit[1] d;",
    "OPENQASM 3.0; qubit[2] q; bit[1] c; c = measure q;",
    "OPENQASM 3.0; qubit[1] q; bit[2] c; if (c == 1) x q[0];",
    "OPENQASM 3.0; qubit[1] q; bit[1] c; if (d[0] == 1) x q[0];",
    "OPENQASM 3.0; qubit[1] q; bit[1] c; c[0] = measure r[0];",
    "OPENQASM 3.0; qubit[1] q; bit[1] c; reset r[0];",
    "OPENQASM 3.0; qubit[1] q; qubit[1] r;",
    "OPENQASM 3.0; bit[1] c;",
])
def test_dynamic_parse_errors_match_jax(text):
    with pytest.raises(TP.QasmError) as got:
        TP.parse_qasm_dynamic(text)
    with pytest.raises(JP.QasmError) as want:
        JP.parse_qasm_dynamic(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn", ["parse_qasm_dynamic", "parse_qasm_dynamic_file"])
def test_dynamic_parse_names_its_roadmap_item(fn, tmp_path):
    """Both dynamic entry points are ported: no NotImplementedError names
    a ROADMAP item any more, and each returns the JAX package's items."""
    text = ("OPENQASM 3.0; qubit[1] q; bit[1] c; "
            "c[0] = measure q[0];")
    arg = text
    if fn == "parse_qasm_dynamic_file":
        arg = str(tmp_path / "m.qasm")
        with open(arg, "w") as f:
            f.write(text)
    got = getattr(TP, fn)(arg)
    assert _dyn_items(got) == _dyn_items(getattr(JP, fn)(arg))
