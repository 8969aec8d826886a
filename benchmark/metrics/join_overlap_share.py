"""Share of the window's joins of a state from the card whose host output
the program had allocated and touched while the card still ran the
state's work (its ``state_join_overlapped`` over its ``state_joins``
counter)."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None:
        return None
    joins = totals.get("state_joins", 0)
    return totals.get("state_join_overlapped", 0) / joins if joins else None
