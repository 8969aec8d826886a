"""Percent: the hand kernels' least time (roofline.py) over their device
time, summed over the window's launches, each launch's least time taken at
the width of one shard: the configuration's ``num_qubits`` less log2 of
its ``mesh_shape`` (a sharded launch works on one shard)."""

import math


def read(run):
    if not run.trace:
        return None
    shards = math.prod(run.config["simulator"].get("mesh_shape") or [1])
    width = run.config["num_qubits"] - int(math.log2(shards))
    least = spent = 0.0
    for s, e, name, _ in run.trace.hand_launches():
        least += run.trace.table.least_s(name, width)[0]
        spent += (e - s) / 1e6
    return 100.0 * least / spent if spent > 0 else None
