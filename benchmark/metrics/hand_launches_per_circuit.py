"""Launches a request that the program's kernel wrappers count (the
``launches/...`` counters): its own kernels' launches on a card, and a
sharded chain's gswap entries; a kernel's plain torch version, which runs
off the card, is not counted."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None:
        return None
    return sum(v for k, v in totals.items()
               if k.startswith("launches/")) / len(run.requests)
