"""Milliseconds a request in the program's copies of the state to the
host (its ``qsim/d2h`` spans, program clock), from the pinned buffer's
allocation to the copy's end."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_request(run, "qsim/d2h")
