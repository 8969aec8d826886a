"""Mean time from a request's last hand-kernel launch's end to ``sample``'s
return: the sampler and the copy of its indices."""


def read(run):
    return run.trace.tail_ms() if run.trace else None
