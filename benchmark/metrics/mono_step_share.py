"""Share of the window's in-place steps of a monomial op or a dense matrix
that ran as mono steps (the program's ``inplace_mono_steps`` over its
``inplace_mono_steps`` and ``inplace_mat_steps`` counters)."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None:
        return None
    monos = totals.get("inplace_mono_steps", 0)
    steps = monos + totals.get("inplace_mat_steps", 0)
    return monos / steps if steps else None
