"""Milliseconds a request in the program's join of the host parts into one
complex vector (its ``qsim/join`` spans, program clock): the output's
allocation and the two part writes."""

from benchmark import program_spans


def read(run):
    return program_spans.ms_per_request(run, "qsim/join")
