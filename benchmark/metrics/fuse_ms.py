"""Milliseconds a request in gate fusion (the program's ``qsim/fuse``
spans, program clock)."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_request(run, "qsim/fuse")
