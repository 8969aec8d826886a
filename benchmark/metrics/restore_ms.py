"""Mean time from a request's last hand-kernel launch's end to
``run_detailed``'s return: restore, copy to the host and join."""


def read(run):
    return run.trace.tail_ms() if run.trace else None
