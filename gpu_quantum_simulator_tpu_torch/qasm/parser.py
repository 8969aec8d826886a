"""OpenQASM 2/3 subset front-end.

A JAX-free copy of the JAX package's ``qasm/parser.py`` (host code only),
building the port's own ``ir.circuit.Circuit`` and, for the dynamic
subset (``parse_qasm_dynamic``), its ``dynamic.DynamicCircuit``: the same
grammar, the same gates and the same ``QasmError`` messages, held to the
original by ``tests/test_torch_qasm.py``.

Accepts the dialect the reference consumes (quantum_simulator.c:115-254):

* ``OPENQASM 3.0;`` / ``OPENQASM 2.0;`` header and ``include`` lines (skipped)
* one quantum register, declared as any of
  ``qubit[n] q;`` | ``qubit q[n];`` (both forms: quantum_simulator.c:163-166)
  | ``qreg q[n];`` (QASM2)
* gate statements ``name(params)? q[i](, q[j])*;`` over the reference gate set
  ``cx x sx z s sdg t tdg rz h`` (+ ``id``), the front-end extensions
  (``y rx ry u p sxdg``), and the qelib1-exact composite set
  (``cz swap ccx ccz cy ch cswap u1 u2 u3 crz cp cu1 cu3 crx cry rzz rxx``)
* user gate definitions ``gate name(params)? a, b { body }`` — expanded
  recursively at invocation (user definitions shadow builtins; ``U``/``CX``
  are the native u/cx, so inlined qelib1.inc bodies load verbatim);
  ``opaque`` declarations are rejected
* ``//`` line comments, ``barrier`` (ignored), blank lines

Unlike the reference's CUDA variants — which demand a preprocessed
``"<num_q> <num_g>"`` integer header (quantum_simulator_naive.cu:239-240) —
this parser derives all counts itself, so one format feeds every engine.

``rz``'s parameter is evaluated as a Python float expression with ``pi``
available (circuits generated by qiskit often emit e.g. ``rz(pi/2)``).
"""

from __future__ import annotations

import math
import re
from typing import Optional

from ..ir.circuit import Circuit

_TOKEN_SPLIT = re.compile(r";")
_COMMENT = re.compile(r"//[^\n]*")
# qubit[6] q  |  qubit q[6]  |  qreg q[6]
_DECL = re.compile(
    r"^(?:qubit|qreg)\s*(?:\[\s*(\d+)\s*\])?\s*([A-Za-z_]\w*)\s*(?:\[\s*(\d+)\s*\])?$"
)
_GATE = re.compile(r"^([A-Za-z_]\w*)\s*(?:\(([^)]*)\))?\s*(.*)$", re.S)
_OPERAND = re.compile(r"([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]")

_SKIP_PREFIXES = ("OPENQASM", "include", "barrier", "creg", "bit", "measure", "reset")

_PARAM_ENV = {"pi": math.pi, "tau": math.tau, "e": math.e}


class QasmError(ValueError):
    pass


_PARAM_TOKEN = re.compile(
    r"\s*(?:(\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)"
    r"|([A-Za-z_]\w*)|([()+\-*/]))"
)

# user gate definitions: gate name(params)? args { body }  (QASM2-style,
# also accepted in QASM3 sources; bodies cannot nest braces)
_GATE_DEF = re.compile(
    r"\bgate\s+([A-Za-z_]\w*)\s*(?:\(([^)]*)\))?\s*([^{(]*?)\s*\{([^{}]*)\}",
    re.S,
)
_OPAQUE = re.compile(r"\bopaque\b([^;]*);")
_IDENT = re.compile(r"[A-Za-z_]\w*")
_MAX_GATE_DEPTH = 64


def _extract_gate_defs(text: str):
    """Strip ``gate ... { ... }`` definitions out of the source and return
    (remaining text, {name: (param names, arg names, body statements)}).
    ``opaque`` declarations are rejected — an opaque gate has no matrix."""
    defs: dict = {}

    def grab(m: "re.Match") -> str:
        name = m.group(1).lower()
        params = [p.strip() for p in (m.group(2) or "").split(",") if p.strip()]
        args = [a.strip() for a in m.group(3).replace(",", " ").split()]
        body = [s.strip() for s in m.group(4).split(";") if s.strip()]
        for tok in params + args:
            if not _IDENT.fullmatch(tok):
                raise QasmError(
                    f"bad identifier {tok!r} in definition of gate {name!r}")
        if not args:
            raise QasmError(f"gate {name!r} defined with no qubit arguments")
        defs[name] = (params, args, body)
        return ""

    text = _GATE_DEF.sub(grab, text)
    m = _OPAQUE.search(text)
    if m:
        raise QasmError(
            f"opaque gate cannot be simulated:{m.group(1).rstrip()}")
    return text, defs


def _expand_user_gate(defs: dict, name: str, params, operand_texts, stmt: str):
    """Instantiate one user-gate invocation: substitute actual parameter
    VALUES and operand texts for the formals in each body statement."""
    formal_params, formal_args, body = defs[name]
    if len(params) != len(formal_params):
        raise QasmError(
            f"gate {name!r} expects {len(formal_params)} parameter(s): {stmt!r}")
    if len(operand_texts) != len(formal_args) \
            or len(set(operand_texts)) != len(formal_args):
        raise QasmError(
            f"gate {name!r} expects {len(formal_args)} distinct qubits: {stmt!r}")
    sub = dict(zip(formal_args, operand_texts))
    sub.update({f: f"({v!r})" for f, v in zip(formal_params, params)})

    def repl(s: str) -> str:
        return _IDENT.sub(lambda mm: sub.get(mm.group(0), mm.group(0)), s)

    out = []
    for body_stmt in body:
        gname, p, ops = _split_gate_head(body_stmt)
        head = gname + (f"({repl(p)})" if p is not None else "")
        out.append(f"{head} {repl(ops)}")
    return out


def _eval_param(expr: str) -> float:
    """Recursive-descent arithmetic evaluator for gate parameters.

    Grammar: expr := term (('+'|'-') term)* ; term := unary (('*'|'/')
    unary)* ; unary := ('+'|'-')* atom ; atom := number | pi|tau|e |
    '(' expr ')'.  Same expression language the reference's rz parser
    accepts (quantum_simulator.c:205-208 handles only literals; qiskit
    emits e.g. ``rz(-3*pi/4)``), with no ``eval`` in sight.
    """
    tokens = []
    pos = 0
    while pos < len(expr):
        m = _PARAM_TOKEN.match(expr, pos)
        if not m:
            if expr[pos:].strip():
                raise QasmError(f"unsupported parameter expression: {expr!r}")
            break
        num, ident, op = m.groups()
        if num is not None:
            tokens.append(("num", float(num)))
        elif ident is not None:
            if ident not in _PARAM_ENV:
                raise QasmError(f"unknown constant {ident!r} in {expr!r}")
            tokens.append(("num", _PARAM_ENV[ident]))
        else:
            tokens.append(("op", op))
        pos = m.end()
    it = {"i": 0}

    def peek():
        return tokens[it["i"]] if it["i"] < len(tokens) else (None, None)

    def take():
        tok = peek()
        it["i"] += 1
        return tok

    def atom() -> float:
        kind, val = take()
        if kind == "num":
            return val
        if kind == "op" and val == "(":
            v = parse_expr()
            kind, val = take()
            if (kind, val) != ("op", ")"):
                raise QasmError(f"unbalanced parentheses in {expr!r}")
            return v
        raise QasmError(f"cannot evaluate parameter {expr!r}")

    def unary() -> float:
        sign = 1.0
        while peek() == ("op", "-") or peek() == ("op", "+"):
            if take()[1] == "-":
                sign = -sign
        return sign * atom()

    def term() -> float:
        v = unary()
        while peek()[0] == "op" and peek()[1] in "*/":
            if take()[1] == "*":
                v *= unary()
            else:
                d = unary()
                if d == 0.0:
                    raise QasmError(f"division by zero in {expr!r}")
                v /= d
        return v

    def parse_expr() -> float:
        v = term()
        while peek()[0] == "op" and peek()[1] in "+-":
            if take()[1] == "+":
                v += term()
            else:
                v -= term()
        return v

    if not tokens:
        raise QasmError(f"empty parameter expression in {expr!r}")
    v = parse_expr()
    if it["i"] != len(tokens):
        raise QasmError(f"trailing junk in parameter {expr!r}")
    return v


def _split_gate_head(stmt: str):
    """(name, params_str | None, operands_str) with paren-BALANCED parameter
    scanning — expanded gate bodies nest parentheses (substituted values are
    parenthesized), which a single-level regex group cannot match."""
    m = re.match(r"^([A-Za-z_]\w*)\s*", stmt)
    if not m:
        raise QasmError(f"cannot parse statement: {stmt!r}")
    name, rest = m.group(1), stmt[m.end():]
    if not rest.startswith("("):
        return name, None, rest
    depth = 0
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return name, rest[1:i], rest[i + 1:]
    raise QasmError(f"unbalanced parentheses in statement: {stmt!r}")


def _parse_gate_stmt(stmt: str, reg_name: Optional[str]):
    """(name, params tuple, qubit tuple, operand texts) for one gate stmt.

    A bare register operand (``h q;``) returns qubit ``None`` in its slot —
    the caller broadcasts it (QASM2 register-broadcast semantics)."""
    name, params_str, operands_str = _split_gate_head(stmt)
    name = name.lower()
    qubits = []
    texts = []
    for tok in operands_str.split(","):
        tok = tok.strip()
        if not tok:
            raise QasmError(f"empty operand in {stmt!r}")
        m = _OPERAND.fullmatch(tok)
        if m:
            rname, idx = m.groups()
            if reg_name is not None and rname != reg_name:
                raise QasmError(f"unknown register {rname!r} in {stmt!r}")
            qubits.append(int(idx))
            texts.append(f"{rname}[{idx}]")
            continue
        if _IDENT.fullmatch(tok):
            if reg_name is not None and tok != reg_name:
                raise QasmError(f"unknown register {tok!r} in {stmt!r}")
            qubits.append(None)         # broadcast slot
            texts.append(tok)
            continue
        raise QasmError(f"cannot parse operand {tok!r} in {stmt!r}")
    if not qubits:
        raise QasmError(f"gate {name!r} with no qubit operands: {stmt!r}")
    params = ()
    if params_str is not None and params_str.strip():
        params = tuple(_eval_param(p) for p in params_str.split(","))
    return name, params, tuple(qubits), tuple(texts)


_MODIFIER = re.compile(
    r"^(inv|ctrl|negctrl|pow)\s*(?:\(([^()]*)\))?\s*@\s*(.*)$", re.S)
# trailing comma-separated operand list (the innermost gate's operands)
_OPERAND_TAIL = re.compile(
    r"^(.*?[\s)@])\s*"
    r"((?:[A-Za-z_]\w*(?:\s*\[\s*\d+\s*\])?)"
    r"(?:\s*,\s*[A-Za-z_]\w*(?:\s*\[\s*\d+\s*\])?)*)$", re.S)


def _emit_modified(circuit: Circuit, stmt: str, reg_name: Optional[str],
                   defs: dict, depth: int) -> None:
    """Lower a QASM3 gate-modifier chain: ``inv @``, ``pow(k) @``,
    ``ctrl(n) @``, ``negctrl(n) @``.

    The modified statement expands into a scratch circuit, which (by the
    IR's construction) contains only 1q natives and cx — so ``inv``/
    ``pow`` are Circuit.inverse/repetition, and ``ctrl`` lowers every
    scratch gate exactly: 1q U -> p(gamma) on the control + cu3 (ZYZ,
    ir.decompose.zyz_angles), cx -> ccx.  Modifiers nest arbitrarily
    (``ctrl @ ctrl @ x`` == ccx == ``ctrl(2) @ x``)."""
    m = _MODIFIER.match(stmt)
    kind, arg, rest = m.group(1), m.group(2), m.group(3).strip()

    def scratch(sub: str) -> Circuit:
        tmp = Circuit(circuit.num_qubits)
        _emit_gate_stmt(tmp, sub, reg_name, defs, depth + 1)
        return tmp

    if kind == "inv":
        if arg is not None:
            raise QasmError(f"inv takes no argument: {stmt!r}")
        circuit.compose(scratch(rest).inverse())
        return
    if kind == "pow":
        k = _eval_param(arg or "")
        tmp = scratch(rest)
        if abs(k - round(k)) <= 1e-9:
            k = int(round(k))
            body = tmp if k >= 0 else tmp.inverse()
            for _ in range(abs(k)):
                circuit.compose(body)
            return
        # fractional power: exact for a single 1q target via the principal
        # matrix power (eigenvalues^k); the leftover global phase is real
        # amplitude content here, emitted as p(g); x; p(g); x == e^{ig} I
        if len(tmp.gates) != 1 or tmp.gates[0].name == "cx":
            raise QasmError(
                "fractional pow() needs a single one-qubit target: "
                f"{stmt!r}")
        import numpy as np

        from ..ir.decompose import zyz_angles

        g = tmp.gates[0]
        w, v = np.linalg.eig(g.matrix())
        u = (v * (w.astype(complex) ** k)) @ np.linalg.inv(v)
        theta, phi, lam, gamma = zyz_angles(u)
        q = g.qubits[0]
        if abs(gamma) > 1e-12:
            circuit.append("p", q, params=(gamma,))
            circuit.x(q)
            circuit.append("p", q, params=(gamma,))
            circuit.x(q)
        circuit.append("u", q, params=(theta, phi, lam))
        return

    # ctrl(n) / negctrl(n): peel the FIRST operand as this level's control
    nc = 1
    if arg is not None:
        nc = _eval_param(arg)
        if abs(nc - round(nc)) > 1e-9 or round(nc) < 1:
            raise QasmError(f"bad control count in {stmt!r}")
        nc = int(round(nc))
    tail = _OPERAND_TAIL.match(rest)
    if not tail:
        raise QasmError(f"cannot parse modified statement: {stmt!r}")
    head, opnds = tail.group(1).strip(), [
        t.strip() for t in tail.group(2).split(",")]
    gp = _GPHASE.match(head)
    if gp:
        # gphase is zero-qubit, so ALL operands are controls:
        # ctrl(n) @ gphase(g) == ctrl(n-1) @ p(g) with the last control as
        # p's target (the OpenQASM 3 spelling of a multi-controlled phase);
        # a negctrl level conjugates its own control with x
        if len(opnds) != nc:
            raise QasmError(
                f"{kind}({nc}) @ gphase needs exactly {nc} control "
                f"operand(s): {stmt!r}")
        gamma = _eval_param(gp.group(1))
        if nc > 1:
            # first nc-1 operands stay controls, the last becomes p's target
            inner = f"{kind}({nc - 1}) @ p({gamma!r}) {', '.join(opnds)}"
        else:
            inner = f"p({gamma!r}) {opnds[0]}"
        if kind == "negctrl":
            lm = _OPERAND.fullmatch(opnds[-1])
            if not lm:
                raise QasmError(
                    f"control operand must be an indexed qubit: {stmt!r}")
            lq = int(lm.group(2))
            circuit.x(lq)
            _emit_gate_stmt(circuit, inner, reg_name, defs, depth + 1)
            circuit.x(lq)
        else:
            _emit_gate_stmt(circuit, inner, reg_name, defs, depth + 1)
        return
    if len(opnds) < nc + 1:
        raise QasmError(
            f"{kind}({nc}) needs {nc} control operand(s) plus targets: "
            f"{stmt!r}")
    cm = _OPERAND.fullmatch(opnds[0])
    if not cm:
        raise QasmError(
            f"control operand must be an indexed qubit: {stmt!r}")
    if reg_name is not None and cm.group(1) != reg_name:
        raise QasmError(f"unknown register {cm.group(1)!r} in {stmt!r}")
    cq = int(cm.group(2))
    if not 0 <= cq < circuit.num_qubits:
        raise QasmError(f"control qubit {cq} out of range: {stmt!r}")

    inner = f"{head} {', '.join(opnds[1:])}"
    if nc > 1:
        inner = f"{kind}({nc - 1}) @ {inner}"
    tmp = scratch(inner)
    used = {q for g in tmp.gates for q in g.qubits}
    if cq in used:
        raise QasmError(
            f"control qubit q[{cq}] overlaps the target gate: {stmt!r}")

    from ..ir.decompose import emit_composite, zyz_angles

    if kind == "negctrl":
        circuit.x(cq)
    for g in tmp.gates:
        if g.name == "cx":
            emit_composite(circuit, "ccx", (cq, *g.qubits))
        elif g.name == "id":
            continue
        else:
            theta, phi, lam, gamma = zyz_angles(g.matrix())
            if abs(gamma) > 1e-12:
                circuit.append("p", cq, params=(gamma,))
            emit_composite(circuit, "cu3", (cq, g.qubits[0]),
                           (theta, phi, lam))
    if kind == "negctrl":
        circuit.x(cq)


_GPHASE = re.compile(r"^gphase\s*\((.*)\)\s*$", re.S)

# OpenQASM 3 classical subset: compile-time parameters and loops, expanded
# textually before the statement walk (the same substitution architecture
# user gate definitions use)
_TYPE = r"(?:float|angle|int|uint|bool)\s*(?:\[\s*\d+\s*\])?"
_INPUT_DECL = re.compile(rf"\binput\s+{_TYPE}\s+([A-Za-z_]\w*)\s*;")
_CONST_DECL = re.compile(
    rf"\bconst\s+{_TYPE}\s+([A-Za-z_]\w*)\s*=\s*([^;]+);")
_FOR_HEAD = re.compile(
    rf"\bfor\s+{_TYPE}\s+([A-Za-z_]\w*)\s+in\s*"
    r"(\[[^\][]*\]|\{[^{}]*\})\s*\{")
_INDEX = re.compile(r"([A-Za-z_]\w*)\s*\[([^\][]+)\]")
_MAX_LOOP_TRIP = 1 << 16


def _subst_ident(text: str, name: str, value) -> str:
    if isinstance(value, int):
        lit = f"({value})" if value >= 0 else f"(0-{-value})"
    else:
        lit = f"({value!r})"
    return re.sub(rf"\b{re.escape(name)}\b", lit, text)


def _loop_values(var: str, spec: str, stmt_tag: str):
    """Values of a for-loop iterable: ``[a:b]`` (inclusive, QASM3),
    ``[a:step:b]``, or the set form ``{v1, v2, ...}``."""
    def as_int(expr: str) -> int:
        v = _eval_param(expr)
        iv = int(round(v))
        if abs(v - iv) > 1e-9:
            raise QasmError(f"non-integer loop bound {expr!r} in {stmt_tag}")
        return iv

    if spec.startswith("{"):
        return [_eval_param(p) for p in spec[1:-1].split(",") if p.strip()]
    parts = [p.strip() for p in spec[1:-1].split(":")]
    if len(parts) == 2:
        a, step, b = as_int(parts[0]), 1, as_int(parts[1])
    elif len(parts) == 3:
        a, step, b = as_int(parts[0]), as_int(parts[1]), as_int(parts[2])
    else:
        raise QasmError(f"cannot parse loop range {spec!r} in {stmt_tag}")
    if step == 0:
        raise QasmError(f"zero loop step in {stmt_tag}")
    vals = list(range(a, b + (1 if step > 0 else -1), step))
    if len(vals) > _MAX_LOOP_TRIP:
        raise QasmError(
            f"loop trip count {len(vals)} exceeds {_MAX_LOOP_TRIP}")
    return vals


def _expand_for_loops(text: str) -> str:
    """Unroll ``for <type> v in <range> { body }`` blocks (outermost first;
    nested loops expand on the re-scan).  Gate definitions are already
    extracted, so every remaining ``{`` after a for-head is loop body."""
    guard = 0
    while True:
        m = _FOR_HEAD.search(text)
        if m is None:
            return text
        guard += 1
        if guard > _MAX_LOOP_TRIP:
            raise QasmError("for-loop expansion does not terminate")
        depth = 1
        i = m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        if depth:
            raise QasmError(f"unbalanced braces in for loop: {m.group(0)!r}")
        var, body = m.group(1), text[m.end():i - 1]
        vals = _loop_values(var, m.group(2).strip(), m.group(0).strip())
        unrolled = "".join(_subst_ident(body, var, v) for v in vals)
        text = text[:m.start()] + unrolled + text[i:]


def _normalize_indices(text: str) -> str:
    """Evaluate arithmetic register indices (``q[2*i+1]`` after loop
    substitution) down to the plain-integer form the operand grammar
    takes.  Tokens that don't evaluate (register declarations, classical
    bits) pass through untouched."""
    def norm(m: "re.Match") -> str:
        name, expr = m.group(1), m.group(2)
        if re.fullmatch(r"\s*\d+\s*", expr):
            return f"{name}[{expr.strip()}]"
        try:
            v = _eval_param(expr)
        except QasmError:
            return m.group(0)
        iv = int(round(v))
        if abs(v - iv) > 1e-9:
            raise QasmError(f"non-integer register index {expr!r}")
        return f"{name}[{iv}]"

    return _INDEX.sub(norm, text)


def _expand_classical(text: str, inputs) -> str:
    """Resolve ``input``/``const`` declarations against the caller-supplied
    values, substituting literals for the names (runs before gate-def
    extraction so definitions may reference them too)."""
    inputs = dict(inputs or {})
    bound: list = []

    def take_input(m: "re.Match") -> str:
        name = m.group(1)
        if name not in inputs:
            raise QasmError(
                f"no value for input {name!r}: pass parse_qasm(...,"
                f" inputs={{{name!r}: <value>}})")
        bound.append(name)
        return ""

    text = _INPUT_DECL.sub(take_input, text)
    for name in bound:
        v = inputs[name]
        text = _subst_ident(
            text, name, int(v) if isinstance(v, (int, bool)) else float(v))
    while True:
        m = _CONST_DECL.search(text)
        if m is None:
            return text
        val = _eval_param(m.group(2))
        ival = int(round(val))
        text = text[:m.start()] + text[m.end():]
        text = _subst_ident(
            text, m.group(1), ival if abs(val - ival) <= 1e-12 else val)


def _emit_gate_stmt(circuit: Circuit, stmt: str, reg_name: Optional[str],
                    defs: dict, depth: int = 0) -> None:
    """Lower one gate statement: user definitions (recursively expanded)
    win over the builtin composite set; everything else is native."""
    if depth > _MAX_GATE_DEPTH:
        raise QasmError(f"gate definitions nest too deeply at: {stmt!r}")
    if _MODIFIER.match(stmt):
        _emit_modified(circuit, stmt, reg_name, defs, depth)
        return
    g = _GPHASE.match(stmt)
    if g:
        # zero-qubit global phase (OpenQASM 3): e^{ig} I is real amplitude
        # content for a state-vector simulator — emitted on qubit 0 as
        # p(g); x; p(g); x == diag(e^{ig}, e^{ig})
        gamma = _eval_param(g.group(1))
        circuit.append("p", 0, params=(gamma,))
        circuit.x(0)
        circuit.append("p", 0, params=(gamma,))
        circuit.x(0)
        return
    name, params, qubits, texts = _parse_gate_stmt(stmt, reg_name)
    if any(q is None for q in qubits):
        # register broadcast: every bare-register slot ranges over the full
        # register in lockstep (QASM2 semantics; indexed slots stay fixed)
        for k in range(circuit.num_qubits):
            sub = " , ".join(
                f"{reg_name}[{k}]" if q is None else t
                for q, t in zip(qubits, texts))
            head = stmt[:len(stmt) - len(_split_gate_head(stmt)[2])]
            _emit_gate_stmt(circuit, f"{head.strip()} {sub}", reg_name,
                            defs, depth + 1)
        return
    if name in defs:
        for sub in _expand_user_gate(defs, name, params, texts, stmt):
            _emit_gate_stmt(circuit, sub, reg_name, defs, depth + 1)
        return
    try:
        from ..ir.decompose import COMPOSITE_GATES, emit_composite

        if name in COMPOSITE_GATES:
            emit_composite(circuit, name, qubits, params)
        else:
            circuit.append(name, *qubits, params=params)
    except ValueError as exc:
        raise QasmError(f"{exc}: {stmt!r}") from exc


# The reference's CUDA variants demand a preprocessed "<num_q> <num_g>"
# integer header instead of QASM declarations (quantum_simulator_naive.cu:
# 239-240; error text :371-373).  No QASM statement starts with a bare
# integer, so the first token disambiguates the two formats.
_PRECOUNT = re.compile(r"^\s*(\d+)\s+(\d+)\s")


def _parse_precounted(text: str, num_q: int, num_g: int) -> Circuit:
    """Parse the CUDA variants' pre-counted format: ``<num_q> <num_g>``
    then plain gate statements (no qubit/include lines).  Mirrors the
    reference reader (quantum_simulator_naive.cu:258-398): exactly
    ``num_g`` gates are consumed, trailing content is ignored, and EOF
    before ``num_g`` gates ends the circuit early."""
    if num_q < 1:
        raise QasmError(f"pre-counted header declares {num_q} qubits")
    circuit = Circuit(num_q)
    count = 0
    for raw in _TOKEN_SPLIT.split(text):
        if count >= num_g:
            break
        stmt = raw.strip()
        if not stmt:
            continue
        # reg_name=None: the reference reader never checks register names
        # (it scans straight to the '[' index), so neither do we here
        _emit_gate_stmt(circuit, stmt, reg_name=None, defs={})
        count += 1
    return circuit


def parse_qasm(text: str, inputs=None) -> Circuit:
    """Parse QASM source text into a Circuit.

    ``inputs``: values for OpenQASM 3 ``input`` declarations (compile-time
    parameters), e.g. ``parse_qasm(src, inputs={"theta": 0.3})``.  The
    classical subset — ``input``/``const`` declarations, ``for`` loops
    over integer ranges or value sets, and arithmetic register indices
    like ``q[2*i+1]`` — is expanded before the statement walk, so
    parameterized loop-structured QASM 3 files load directly.

    Files in the reference CUDA variants' pre-counted format (first line
    ``<num_q> <num_g>``, then gate statements) are accepted too, so every
    reference-era input file is drop-in."""
    text = _COMMENT.sub("", text)
    pc = _PRECOUNT.match(text)
    if pc:
        return _parse_precounted(text[pc.end():], int(pc.group(1)),
                                 int(pc.group(2)))
    text = _expand_classical(text, inputs)
    text, defs = _extract_gate_defs(text)
    text = _normalize_indices(_expand_for_loops(text))
    circuit: Optional[Circuit] = None
    reg_name: Optional[str] = None

    for raw in _TOKEN_SPLIT.split(text):
        stmt = raw.strip()
        if not stmt:
            continue
        if stmt.startswith(_SKIP_PREFIXES):
            continue

        m = _DECL.match(stmt)
        if m:
            n = m.group(1) or m.group(3)
            if n is None:
                raise QasmError(f"register declaration without a size: {stmt!r}")
            if circuit is not None:
                raise QasmError("multiple quantum registers are not supported")
            circuit = Circuit(int(n))
            reg_name = m.group(2)
            continue

        if circuit is None:
            raise QasmError(f"gate before qubit register declaration: {stmt!r}")
        _emit_gate_stmt(circuit, stmt, reg_name, defs)

    if circuit is None:
        raise QasmError("no qubit register declaration found")
    return circuit


def parse_qasm_file(path: str, inputs=None) -> Circuit:
    with open(path, "r", encoding="utf-8") as f:
        return parse_qasm(f.read(), inputs=inputs)


# --- dynamic-circuit subset (measure / reset / if) ---------------------

_CDECL = re.compile(
    r"^(?:creg|bit)\s*(?:\[\s*(\d+)\s*\])?\s*([A-Za-z_]\w*)\s*(?:\[\s*(\d+)\s*\])?$"
)
# measure q[i] -> c[j]      (QASM2)
_MEASURE2 = re.compile(
    r"^measure\s+([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]\s*->\s*([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]$"
)
# c[j] = measure q[i]       (QASM3)
_MEASURE3 = re.compile(
    r"^([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]\s*=\s*measure\s+([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]$"
)
_RESET = re.compile(r"^reset\s+([A-Za-z_]\w*)\s*\[\s*(\d+)\s*\]$")
# whole-register broadcast forms: measure q -> c; | c = measure q; | reset q;
_MEASURE2_ALL = re.compile(
    r"^measure\s+([A-Za-z_]\w*)\s*->\s*([A-Za-z_]\w*)$")
_MEASURE3_ALL = re.compile(
    r"^([A-Za-z_]\w*)\s*=\s*measure\s+([A-Za-z_]\w*)$")
_RESET_ALL = re.compile(r"^reset\s+([A-Za-z_]\w*)$")
# if (c[j] == v) stmt | if (c[j]) stmt | if (c == v) stmt (1-bit register)
_IF = re.compile(
    r"^if\s*\(\s*([A-Za-z_]\w*)\s*(?:\[\s*(\d+)\s*\])?\s*(?:==\s*(\d+)\s*)?\)\s*(.*)$",
    re.S,
)


def parse_qasm_dynamic(text: str, inputs=None):
    """Parse the dynamic-circuit OpenQASM subset into a DynamicCircuit.

    On top of the static grammar: classical registers (``creg c[n];`` /
    ``bit[n] c;``), measurement in both dialects (``measure q[i] -> c[j];``
    / ``c[j] = measure q[i];``), ``reset q[i];`` and classically
    conditioned gates (``if (c[j] == 1) x q[0];``; bare ``if (c[j])``
    means ``== 1``; a whole 1-bit register may be named without an index).
    The compile-time classical subset (``input``/``const``/``for``, see
    ``parse_qasm``) expands here too.
    The reference parses-and-ignores measurement (its sampling loop is
    disabled, quantum_simulator.c:68-73) — here it drives trajectories.
    """
    from ..dynamic import DynamicCircuit

    text = _COMMENT.sub("", text)
    text = _expand_classical(text, inputs)
    text, defs = _extract_gate_defs(text)
    text = _normalize_indices(_expand_for_loops(text))
    dc: Optional[DynamicCircuit] = None
    reg_name: Optional[str] = None
    creg_name: Optional[str] = None
    creg_size = 0

    def _gate_into(target_items, stmt, cond=None):
        tmp = Circuit(dc.num_qubits)
        _emit_gate_stmt(tmp, stmt, reg_name, defs)
        if cond is not None:
            from ..dynamic import CondGate

            clbit, value = cond
            for g in tmp.gates:
                target_items.append(CondGate(g, clbit, value))
        else:
            target_items.extend(tmp.gates)

    for raw in _TOKEN_SPLIT.split(text):
        stmt = raw.strip()
        if not stmt:
            continue
        if stmt.startswith(("OPENQASM", "include", "barrier")):
            continue

        m = _CDECL.match(stmt)
        if m:
            n = m.group(1) or m.group(3)
            if n is None:
                raise QasmError(f"classical declaration without a size: {stmt!r}")
            if creg_name is not None:
                raise QasmError("multiple classical registers are not supported")
            creg_name = m.group(2)
            creg_size = int(n)
            if dc is not None:
                dc.num_clbits = creg_size
            continue

        m = _DECL.match(stmt)
        if m and not stmt.startswith(("measure", "reset", "if")):
            n = m.group(1) or m.group(3)
            if n is None:
                raise QasmError(f"register declaration without a size: {stmt!r}")
            if dc is not None:
                raise QasmError("multiple quantum registers are not supported")
            dc = DynamicCircuit(int(n), num_clbits=creg_size)
            reg_name = m.group(2)
            continue

        if dc is None:
            raise QasmError(f"statement before qubit register declaration: {stmt!r}")

        m = _MEASURE2.match(stmt) or _MEASURE3.match(stmt)
        if m:
            g = m.groups()
            if stmt.startswith("measure"):
                qreg, q, creg, c = g
            else:
                creg, c, qreg, q = g
            if qreg != reg_name or (creg_name and creg != creg_name):
                raise QasmError(f"unknown register in {stmt!r}")
            dc.measure(int(q), int(c))
            continue

        m = _RESET.match(stmt)
        if m:
            if m.group(1) != reg_name:
                raise QasmError(f"unknown register in {stmt!r}")
            dc.reset(int(m.group(2)))
            continue

        m = _MEASURE2_ALL.match(stmt) or _MEASURE3_ALL.match(stmt)
        if m:
            g = m.groups()
            qreg, creg = g if stmt.startswith("measure") else (g[1], g[0])
            if qreg != reg_name or (creg_name and creg != creg_name):
                raise QasmError(f"unknown register in {stmt!r}")
            if creg_size < dc.num_qubits:
                raise QasmError(
                    f"classical register too small for broadcast: {stmt!r}")
            for q in range(dc.num_qubits):
                dc.measure(q, q)
            continue

        m = _RESET_ALL.match(stmt)
        if m:
            if m.group(1) != reg_name:
                raise QasmError(f"unknown register in {stmt!r}")
            for q in range(dc.num_qubits):
                dc.reset(q)
            continue

        m = _IF.match(stmt)
        if m:
            cname, cidx, val, body = m.groups()
            if creg_name and cname != creg_name:
                raise QasmError(f"unknown classical register in {stmt!r}")
            if cidx is None:
                if creg_size != 1:
                    raise QasmError(
                        f"whole-register condition needs a 1-bit register: {stmt!r}")
                cidx = 0
            _gate_into(dc.items, body.strip(),
                       cond=(int(cidx), int(val) if val is not None else 1))
            continue

        _gate_into(dc.items, stmt)

    if dc is None:
        raise QasmError("no qubit register declaration found")
    return dc


def parse_qasm_dynamic_file(path: str, inputs=None):
    with open(path, "r", encoding="utf-8") as f:
        return parse_qasm_dynamic(f.read(), inputs=inputs)
