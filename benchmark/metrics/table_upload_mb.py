"""Megabytes (10^6 bytes) of gate tables a request hands to the device
(the program's ``table_h2d_bytes`` counter)."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None:
        return None
    return totals.get("table_h2d_bytes", 0) / 1e6 / len(run.requests)
