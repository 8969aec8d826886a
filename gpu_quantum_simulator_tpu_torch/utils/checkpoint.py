"""State-vector checkpoint / resume.

The port of the JAX package's ``utils/checkpoint.py``: the same compressed
``.npz`` files, with the same keys (``re``/``im`` flat, or ``re0``,
``re1``, ``im0``, ``im1`` for the four column halves of the in-place
layout) and the same JSON ``meta`` record, so a file written by either
package loads in the other.  The state may be numpy arrays or torch
tensors on any device; tensors are fetched to the host first.  At n = 30
a state is an 8 GB file: the halves form writes the in-place engine's
buffers as they are and never joins a flat 2^n state.

The sharded checkpoints (``save_state_sharded``/``load_state_sharded``)
belong to the mesh-sharded engine and raise until it is ported.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from ..ops.apply import _to_host as _host


def save_state(path: str, re, im, num_qubits: int,
               meta: Optional[dict] = None) -> None:
    re = _host(re)
    im = _host(im)
    if re.shape != (1 << num_qubits,) or im.shape != re.shape:
        raise ValueError("state arrays do not match num_qubits")
    record = {"num_qubits": num_qubits, "dtype": str(re.dtype)}
    if meta:
        record.update(meta)
    np.savez_compressed(path, re=re, im=im, meta=json.dumps(record))


def load_state(path: str) -> Tuple[np.ndarray, np.ndarray, dict]:
    with np.load(path) as z:
        re, im = z["re"], z["im"]
        meta = json.loads(str(z["meta"]))
    if re.shape != (1 << int(meta["num_qubits"]),):
        raise ValueError(f"corrupt checkpoint: shape {re.shape} vs meta {meta}")
    return re, im, meta


def save_state_halves(path: str, re0, re1, im0, im1, num_qubits: int,
                      meta: Optional[dict] = None) -> None:
    """Checkpoint a column-half-split state (the in-place layout) without
    a flat 2^n join: the four (2^(n-8), 128) halves are fetched and
    written as they are."""
    halves = [_host(x) for x in (re0, re1, im0, im1)]
    want = (1 << (num_qubits - 8), 128)
    for h in halves:
        if h.shape != want:
            raise ValueError(
                f"half shape {h.shape} != {want} for n = {num_qubits}")
    record = {"num_qubits": num_qubits, "dtype": str(halves[0].dtype),
              "layout": "halves"}
    if meta:
        record.update(meta)
    np.savez_compressed(path, re0=halves[0], re1=halves[1], im0=halves[2],
                        im1=halves[3], meta=json.dumps(record))


def load_state_halves(path: str):
    """((re0, re1, im0, im1), meta) from a :func:`save_state_halves` file;
    the halves feed ``Simulator.run_device_halves(initial_parts=)``."""
    with np.load(path) as z:
        if "re0" not in z:
            raise ValueError(
                f"{path} is not a split-state checkpoint (no 're0'); "
                "use load_state")
        parts = (z["re0"], z["re1"], z["im0"], z["im1"])
        meta = json.loads(str(z["meta"]))
    want = (1 << (int(meta["num_qubits"]) - 8), 128)
    if parts[0].shape != want:
        raise ValueError(f"corrupt checkpoint: {parts[0].shape} vs {meta}")
    return parts, meta


_SHARDED = ("sharded checkpoints hold a mesh-sharded state, not yet ported "
            "(ROADMAP queue A, \"parallel/ on torch.distributed\")")


def save_state_sharded(path: str, re, im, num_qubits: int,
                       meta: Optional[dict] = None) -> None:
    raise NotImplementedError(_SHARDED)


def load_state_sharded(path: str, mesh=None, axis: Optional[str] = None):
    raise NotImplementedError(_SHARDED)
