"""The window's whole time over the circuits completed in it, each to its
shots' indices on the host (host clock)."""


def read(run):
    return run.window_s / len(run.requests)
