"""Gigabytes (10^9 bytes) a second of the program's copies of the state
from the card to the host: its ``state_d2h_bytes`` counter over the time
of its ``qsim/d2h`` spans (program clock)."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    ms = program_spans.ms_per_request(run, "qsim/d2h")
    if totals is None or not ms:
        return None
    return totals.get("state_d2h_bytes", 0) / len(run.requests) / (ms * 1e6)
