"""Entry ``run_detailed``: a request is ``Simulator.run_detailed(circuit)``
and its answer the 2^n complex amplitudes on the host.

Judged: every answer against the reference's state of its own circuit (one
reference a distinct circuit), by ``amp_err``.
"""

import math

from benchmark import check


def call(cell, circuit, i):
    return cell.sim.run_detailed(circuit).state


def judge(cell, answers, kept, reference):
    """({"amp_err": worst answer's}, answers failed)."""
    refs, errs = {}, []
    for i, answer in enumerate(answers):
        k = i % len(cell.gates)
        if k not in refs:
            refs.clear()           # one reference held at a time
            refs[k] = reference.simulate(cell.gates[k], cell.n,
                                         device=cell.ref_device)
        errs.append(check.amp_err(answer, refs[k]))
    return ({"amp_err": max(errs)},
            sum(not math.isfinite(e) for e in errs))
