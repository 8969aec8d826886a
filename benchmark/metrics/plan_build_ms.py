"""Milliseconds a request in planning outside fusion and table uploads:
the self time of the program's ``qsim/plan`` spans (permutation,
fingerprint, cache lookups and, on a miss, the plan and its host tables),
program clock."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_request(run, "qsim/plan", own=True)
