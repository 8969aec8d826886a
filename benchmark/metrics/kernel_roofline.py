"""Percent: the hand kernels' least time (roofline.py) over their device
time, summed over the window's launches."""


def read(run):
    return run.trace.kernel_roofline_pct() if run.trace else None
