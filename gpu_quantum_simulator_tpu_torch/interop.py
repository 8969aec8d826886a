"""Interop: import circuits from other ecosystems.

The JAX package's ``interop.py`` copied (host code, no torch needed);
``from_qiskit_dynamic`` builds the port's own ``DynamicCircuit``.

``from_qiskit`` converts a qiskit ``QuantumCircuit`` (if qiskit is
installed — it is an optional dependency, never required) into the native
``Circuit`` IR.  Supported: the reference gate set + this library's
extensions (h x y z s sdg t tdg sx rx ry rz p u cx cz swap ccx ccz;
barrier/delay/id silently ignored).  ``measure`` raises in strict mode —
mid-circuit measurement needs ``DynamicCircuit`` — and is dropped (and
reported via ``dropped``) with ``strict=False``.

Qubit convention note: qiskit's little-endian qubit indexing matches this
library's (qubit k = bit k of the basis index), so indices map 1:1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ir.circuit import Circuit

_DIRECT = {
    "h", "x", "y", "z", "s", "sdg", "t", "tdg", "sx", "sxdg",
    "rx", "ry", "rz", "p", "u",
}
_COMPOSITE = {"cz", "swap", "ccx", "ccz", "cy", "ch", "cswap", "crz",
              "cp", "cu1", "cu3", "crx", "cry", "rzz", "rxx", "ryy", "u2"}
_IGNORED = {"barrier", "delay", "id"}


def from_qiskit(qc, *, strict: bool = True,
                dropped: Optional[List[str]] = None) -> Circuit:
    """Convert a qiskit QuantumCircuit to the native Circuit IR.

    ``strict=False`` drops unsupported instructions instead of raising;
    pass a list as ``dropped`` to collect their names.
    """
    try:
        num_qubits = qc.num_qubits
        data = qc.data
    except AttributeError as exc:
        raise TypeError(
            "from_qiskit expects a qiskit QuantumCircuit-like object "
            "(num_qubits + data)") from exc

    out = Circuit(num_qubits)
    for inst in data:
        # qiskit >= 1.0: CircuitInstruction with .operation / .qubits
        op = getattr(inst, "operation", None)
        if op is None:                      # legacy (op, qargs, cargs) tuple
            op, qargs = inst[0], inst[1]
        else:
            qargs = inst.qubits
        name = op.name.lower()
        if name in _IGNORED:
            continue
        if name == "measure":
            # A mid-circuit measurement changes the semantics: dropping it
            # silently would return a pure-unitary circuit that computes a
            # different state.  DynamicCircuit is the supported path.
            if strict:
                raise ValueError(
                    "circuit contains 'measure'; mid-circuit measurement is "
                    "not expressible in the pure-unitary Circuit IR — use "
                    "gpu_quantum_simulator_tpu_torch.dynamic.DynamicCircuit, or "
                    "pass strict=False to drop measurements")
            if dropped is not None:
                dropped.append(name)
            continue
        try:
            qubits = tuple(qc.find_bit(q).index for q in qargs)
        except AttributeError:
            qubits = tuple(getattr(q, "index") for q in qargs)
        if name == "unitary":
            # UnitaryGate: params[0] is the matrix (little-endian over
            # qargs, same convention as Circuit.unitary); 1q/2q via KAK
            try:
                _emit_unitary_inst(out, op, qubits)
            except _Unsupported as exc:
                if strict:
                    raise ValueError(
                        f"unsupported qiskit instruction: {exc}; pass "
                        f"strict=False to drop it") from None
                if dropped is not None:
                    dropped.append(name)
            continue
        params = tuple(float(p) for p in getattr(op, "params", ()))

        try:
            _emit_gate(out, name, qubits, params)
        except _Unsupported:
            if strict:
                raise ValueError(
                    f"unsupported qiskit instruction {name!r}; pass "
                    f"strict=False to drop it") from None
            if dropped is not None:
                dropped.append(name)
    return out


class _Unsupported(Exception):
    pass


def _emit_unitary_inst(out: Circuit, op, qubits) -> None:
    """Lower a qiskit UnitaryGate (raises _Unsupported past 2 qubits)."""
    import numpy as np

    raw = getattr(op, "params", ())
    if raw:
        mat = np.asarray(raw[0], dtype=complex)
    else:  # pragma: no cover - UnitaryGate always carries its matrix
        mat = np.asarray(op.to_matrix(), dtype=complex)
    if len(qubits) > 6:
        raise _Unsupported(f"unitary on {len(qubits)} qubits (max 6)")
    try:
        out.unitary(mat, *qubits)
    except ValueError as exc:
        raise _Unsupported(f"unitary: {exc}") from None


def _emit_gate(out: Circuit, name: str, qubits, params) -> None:
    """Append one mapped qiskit gate to ``out`` (raises _Unsupported)."""
    if name in _DIRECT:
        out.append(name, *qubits, params=params)
    elif name == "cx":
        out.cx(*qubits)
    elif name in _COMPOSITE:
        from .ir.decompose import emit_composite

        try:
            emit_composite(out, name, qubits, params)
        except ValueError as exc:
            raise _Unsupported(f"{name}: {exc}") from None
    elif name == "u3":
        out.append("u", *qubits, params=params)
    elif name == "u1":
        out.append("p", *qubits, params=params)
    else:
        raise _Unsupported(name)


def _bit_index(qc, bit) -> int:
    try:
        return qc.find_bit(bit).index
    except AttributeError:
        return getattr(bit, "index")


def from_qiskit_dynamic(qc, *, strict: bool = True,
                        dropped: Optional[List[str]] = None):
    """Convert a qiskit QuantumCircuit WITH measurements / resets /
    classically-conditioned gates into a ``DynamicCircuit``.

    Conditions are read from the legacy ``op.condition`` form — a
    (clbit-or-1-bit-register, value) pair conditioning a single gate;
    control-flow ops (IfElseOp blocks, loops) are out of scope and raise
    (or are dropped with ``strict=False``).
    """
    from .dynamic import CondGate, DynamicCircuit

    try:
        num_qubits = qc.num_qubits
        data = qc.data
    except AttributeError as exc:
        raise TypeError(
            "from_qiskit_dynamic expects a qiskit QuantumCircuit-like "
            "object (num_qubits + data)") from exc

    dc = DynamicCircuit(num_qubits, num_clbits=getattr(qc, "num_clbits", 0))
    for inst in data:
        op = getattr(inst, "operation", None)
        if op is None:                      # legacy (op, qargs, cargs) tuple
            op, qargs = inst[0], inst[1]
            cargs = inst[2] if len(inst) > 2 else ()
        else:
            qargs = inst.qubits
            cargs = getattr(inst, "clbits", ())
        name = op.name.lower()
        if name in _IGNORED:
            continue
        qubits = tuple(_bit_index(qc, q) for q in qargs)
        if name == "measure":
            for q, c in zip(qubits, (_bit_index(qc, c) for c in cargs)):
                dc.measure(q, c)
            continue
        if name == "reset":
            for q in qubits:
                dc.reset(q)
            continue
        cond = getattr(op, "condition", None)
        tmp = Circuit(num_qubits)
        try:
            if name in ("if_else", "while_loop", "for_loop", "switch_case"):
                raise _Unsupported(name)
            if name == "unitary":
                _emit_unitary_inst(tmp, op, qubits)
            else:
                params = tuple(float(p) for p in getattr(op, "params", ()))
                _emit_gate(tmp, name, qubits, params)
        except _Unsupported:
            if strict:
                raise ValueError(
                    f"unsupported qiskit instruction {name!r}; pass "
                    f"strict=False to drop it") from None
            if dropped is not None:
                dropped.append(name)
            continue
        if cond is None:
            dc.items.extend(tmp.gates)
            continue
        target, value = cond
        if hasattr(target, "__len__"):      # ClassicalRegister
            if len(target) != 1:
                raise ValueError(
                    "only 1-bit register conditions are supported; "
                    "condition on a single clbit instead")
            target = target[0]
        clbit = _bit_index(qc, target)
        for g in tmp.gates:
            dc.items.append(CondGate(g, clbit, int(value)))
    return dc
