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
hold a mesh-sharded state (parallel/) without a gather: a directory with
one ``.npy`` pair a shard and a JSON sidecar.  The JAX package writes the
same content as an orbax store, which the card's machine lacks: the two
formats are equal in content (the amplitudes, ``num_qubits``, ``dtype``
and the caller's meta), not in files, so neither package reads the
other's.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from ..ops.apply import _to_host as _host
from ..parallel.sharded import is_sharded


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


def _shard_files(path: str, s: int):
    import os

    return (os.path.join(path, f"shard{s:05d}_re.npy"),
            os.path.join(path, f"shard{s:05d}_im.npy"))


def save_state_sharded(path: str, re, im, num_qubits: int,
                       meta: Optional[dict] = None) -> None:
    """Checkpoint a MESH-SHARDED state without gathering it.

    ``re``/``im``: the shard lists of a sharded run (parallel/), or flat
    tensors or arrays (one shard).  Each shard is fetched and written on
    its own (``shard<s>_re.npy``, ``shard<s>_im.npy`` under the directory
    ``path``), so no buffer of 2^n amplitudes exists anywhere; metadata
    rides in ``meta.json``.  Restore with ``load_state_sharded`` onto a
    mesh of any shard count.
    """
    import os

    if not is_sharded(re):
        re, im = [re], [im]
    sizes = [int(np.prod(r.shape)) for r in re]
    if (sum(sizes) != 1 << num_qubits or len(im) != len(re)
            or [int(np.prod(i.shape)) for i in im] != sizes
            or len(set(sizes)) != 1):
        raise ValueError("state arrays do not match num_qubits")
    os.makedirs(path, exist_ok=True)
    dtype = None
    for s, (r, i) in enumerate(zip(re, im)):
        fr, fi = _shard_files(path, s)
        r = _host(r).reshape(-1)
        dtype = str(r.dtype)
        np.save(fr, r)
        np.save(fi, _host(i).reshape(-1))
    record = {"num_qubits": num_qubits, "dtype": dtype,
              "num_shards": len(re)}
    if meta:
        record.update(meta)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(record, f)


def load_state_sharded(path: str, mesh=None, axis: Optional[str] = None):
    """Restore a sharded checkpoint as (re, im, meta).

    With ``mesh`` (parallel/mesh.py) the state comes back as shard lists
    over that mesh axis (``axis``: its first by default), whatever shard
    count it was saved with: each new shard reads only its own range of
    the files.  Without, it returns flat numpy arrays (a small-state
    convenience).
    """
    import os

    import torch

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    n = int(meta["num_qubits"])
    saved = int(meta["num_shards"])
    files = [tuple(np.load(f, mmap_mode="r") for f in _shard_files(path, s))
             for s in range(saved)]
    size = 1 << n
    per_saved = size // saved
    if any(r.shape != (per_saved,) or i.shape != (per_saved,)
           for r, i in files):
        raise ValueError(f"corrupt checkpoint: shards of {per_saved} "
                         f"amplitudes expected for {meta}")

    def read(lo: int, hi: int, part: int) -> np.ndarray:
        out = []
        while lo < hi:
            s, off = divmod(lo, per_saved)
            take = min(hi - lo, per_saved - off)
            out.append(files[s][part][off:off + take])
            lo += take
        return np.concatenate(out) if len(out) > 1 else np.array(out[0])

    if mesh is None:
        return read(0, size, 0), read(0, size, 1), meta
    devices = mesh.device_list
    count = mesh.shape[axis or mesh.axis_names[0]]
    if count != len(devices) or size % count:
        raise ValueError(f"cannot shard 2^{n} amplitudes over {mesh}")
    per = size // count
    re, im = [], []
    for s, dev in enumerate(devices):
        for part, dst in ((0, re), (1, im)):
            dst.append(torch.from_numpy(read(s * per, (s + 1) * per, part))
                       .to(dev))
    return re, im, meta
