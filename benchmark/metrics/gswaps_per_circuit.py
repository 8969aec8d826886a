"""Gswap entries a request: the sharded chain's ``launches/gswap``
counter (each a half-block exchange between every shard and its
partner)."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None:
        return None
    return totals.get("launches/gswap", 0) / len(run.requests)
