"""Share of the window's plan- and program-cache lookups that hit (the
program's ``plan_cache_hit`` and ``plan_cache_miss`` counters)."""

from benchmark import program_spans


def read(run):
    totals = program_spans.counter_totals(run)
    if totals is None:
        return None
    hits = totals.get("plan_cache_hit", 0)
    lookups = hits + totals.get("plan_cache_miss", 0)
    return hits / lookups if lookups else None
