"""Mean time from a request's call into the facade to its circuit's first
hand-kernel launch on the card: fusion, planning, tables and upload."""


def read(run):
    return run.trace.lead_ms() if run.trace else None
