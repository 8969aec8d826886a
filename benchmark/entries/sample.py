"""Entry ``sample``: a request is ``Simulator.sample(circuit, shots, seed)``
(the mix's ``shots``, a sampling seed a request) and its answer the shots'
basis indices on the host.

Judged: every request's shots by count and range (``shots_bad``); the
closing request's shots against the reference's distribution
(``shots_z``), and the state that request sampled from against the
reference's state (``amp_err``), since shots alone cannot tell a lower
precision.  That state is kept, uncopied, by ``Capture``.
"""

import contextlib
import math
import time

from benchmark import check
from benchmark.harness import Capture as _Base


def call(cell, circuit, i):
    seeds = cell.sample_seeds
    return cell.sim.sample(circuit, int(cell.mix["shots"]),
                           seed=seeds[i % len(seeds)])


class Capture(_Base):
    """Keeps the state that the facade hands to the sampler, for the request
    whose state was ready at or after ``deadline``: that request closes the
    window, so nothing is held while another runs.  Wraps
    ``Simulator.run_device`` and ``Simulator.run_device_halves``, the two
    calls through which ``Simulator.sample`` runs a circuit on the card;
    ``ready`` is the host clock when the state was ready."""

    @contextlib.contextmanager
    def installed(self):
        from gpu_quantum_simulator_tpu_torch import Simulator

        originals = {k: getattr(Simulator, k)
                     for k in ("run_device", "run_device_halves")}

        def run_device(sim, *a, **k):
            out = originals["run_device"](sim, *a, **k)
            self._offer(out[:2])
            return out

        def run_device_halves(sim, *a, **k):
            out = originals["run_device_halves"](sim, *a, **k)
            self._offer(out[0])
            return out

        Simulator.run_device = run_device
        Simulator.run_device_halves = run_device_halves
        try:
            yield self
        finally:
            for k, v in originals.items():
                setattr(Simulator, k, v)

    def _offer(self, state):
        self.ready = time.perf_counter()
        if self.ready >= self.deadline:
            self.state = tuple(state)


def judge(cell, answers, kept, reference):
    """({"amp_err", "shots_bad", "shots_z"}, answers failed)."""
    n, shots, last = cell.n, int(cell.mix["shots"]), len(answers) - 1
    ref = reference.simulate(cell.gates[last % len(cell.gates)], n,
                             device=cell.ref_device)
    bad = [check.shots_bad(a, n, shots) for a in answers]
    return ({"amp_err": (check.amp_err(kept, ref) if kept is not None
                         else math.inf),
             "shots_bad": sum(bad),
             "shots_z": (check.shots_z(answers[last], ref) if bad[last] == 0
                         else math.inf)},
            sum(b > 0 for b in bad))
