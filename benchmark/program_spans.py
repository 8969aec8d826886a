"""The program's own spans and counters over the measured window.

While the profiler records, the port times its stages itself
(``gpu_quantum_simulator_tpu_torch/telemetry.py``): one record a span,
``{"name", "id", "parent", "request", "start", "end"}`` on the host clock
(``time.perf_counter()``, the clock of the harness's ``run.requests``),
and on each facade request's record ``counters``, every counter's change
over that request.  The window is ``[run.requests[0][0],
run.requests[-1][1]]``; a span is in it when it starts in it.

Every function takes the records as an argument (``records``), or reads
the program's own where it is None, and returns None where the window
holds nothing to read: a program without the telemetry module (an older
commit) or a run that recorded no span.
"""

from __future__ import annotations

import importlib

TELEMETRY = "gpu_quantum_simulator_tpu_torch.telemetry"


def program_records():
    """The program's span records, or None where it keeps none."""
    try:
        telemetry = importlib.import_module(TELEMETRY)
    except ImportError:
        return None
    return telemetry.spans()


def in_window(run, records=None) -> list:
    """The records that start inside the window."""
    if records is None:
        records = program_records() or []
    lo, hi = run.requests[0][0], run.requests[-1][1]
    return [r for r in records if lo <= r["start"] <= hi]


def self_s(rec, records) -> float:
    """``rec``'s duration less the part of it its child spans cover."""
    kids = sorted((max(r["start"], rec["start"]), min(r["end"], rec["end"]))
                  for r in records if r["parent"] == rec["id"])
    covered, reach = 0.0, rec["start"]
    for s, e in kids:
        s = max(s, reach)
        if e > s:
            covered += e - s
            reach = e
    return rec["end"] - rec["start"] - covered


def ms_per_request(run, name: str, own: bool = False, records=None):
    """Milliseconds a request in spans named ``name``: their whole
    durations, or with ``own`` their self times; None where none ran."""
    spans = in_window(run, records)
    mine = [r for r in spans if r["name"] == name]
    if not mine:
        return None
    total = sum(self_s(r, spans) if own else r["end"] - r["start"]
                for r in mine)
    return 1e3 * total / len(run.requests)


def counter_totals(run, records=None):
    """{counter: its change summed over the window's requests}; None where
    no request was recorded."""
    requests = [r for r in in_window(run, records) if "counters" in r]
    if not requests:
        return None
    out: dict = {}
    for r in requests:
        for k, v in r["counters"].items():
            out[k] = out.get(k, 0) + v
    return out
