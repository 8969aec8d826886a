"""The window's whole time over the circuits completed in it, each to its
host amplitude vector (host clock)."""


def read(run):
    return run.window_s / len(run.requests)
