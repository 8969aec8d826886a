"""Kernel launches on the card in the traced window, per circuit."""


def read(run):
    return (len(run.trace.kernels()) / len(run.trace.requests)
            if run.trace else None)
