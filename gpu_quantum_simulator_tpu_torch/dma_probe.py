"""Device-memory copy bandwidth on the card, per copy route and tile shape.

The port's twin of ``scripts/dma_probe.py``: the same three routes, each a
hand-written kernel of ``csrc/copy_probe.cu`` (kernels/copy.py), over the
state of n qubits as the port holds it (the (R2, 256) float32 re/im pair,
R2 = 2^(n-8), or its four (R2, 128) column halves):

  grid1_T{T}, grid2_T{T}, grid4_T{T}
                      grid copy of one operand (re), the pair, the four
                      halves, in T-row tiles through registers;
  stream_T{T}_W{W}    the pair through a W-stage shared-memory ring of
                      T-row tiles (TMA loads, stores from the threads);
  direct_T{T}_W{W}    the pair by TMA bulk copies both ways;
  torch_copy          ``dst.copy_(src)`` on the pair (cudaMemcpyAsync), the
                      library yardstick.

Every kernel's copy is checked bit for bit against its source.  Rates are
bytes read plus bytes written over the kernel's time (CUDA events, the
median of three rounds of five launches).

Usage: ``python -m gpu_quantum_simulator_tpu_torch.dma_probe [n ...]``
(default 24 28 30) on a machine with a card; prints one JSON line per n.
At n = 30 the pair is 8 GiB and the copies need 16 GiB of device memory.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from .kernels import copy as K
from .ops.apply import resolve_device

GRID_TILES = (32, 128, 512)                    # rows: the port's tile shapes
STAGED = ((8, 4), (8, 8), (32, 2), (32, 4))    # (T rows, W stages) that fit
PEAK_GBPS = 3350.0      # H100 SXM HBM3, published, at 700 W


def _time_ms(fn, rounds: int = 3, calls: int = 5) -> float:
    fn()
    ts = []
    for _ in range(rounds):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        torch.cuda.synchronize()
        ts.append(t0.elapsed_time(t1) / calls)
    return sorted(ts)[len(ts) // 2]


def routes(src, dst):
    """(name, operands, outputs, call) for every variant, on a source pair
    and a destination pair of (R2, 256) float32 tensors; the four-halves
    operands are the same buffers seen as (R2, 128) halves."""
    rows = src[0].shape[0]

    def halves(pair):
        return tuple(h.view(rows, 128) for x in pair
                     for h in x.view(-1).chunk(2))

    out = []
    for T in GRID_TILES:
        if rows % T:
            continue
        for name, s, d in (("grid1", src[:1], dst[:1]), ("grid2", src, dst),
                           ("grid4", halves(src), halves(dst))):
            out.append((f"{name}_T{T}", s, d,
                        lambda s=s, d=d, T=T: K.grid_copy(s, T, out=d)))
    for T, W in STAGED:
        if rows % T:
            continue
        out.append((f"stream_T{T}_W{W}", src, dst,
                    lambda T=T, W=W: K.stream_copy(src, T, W, out=dst)))
        out.append((f"direct_T{T}_W{W}", src, dst,
                    lambda T=T, W=W: K.hbm_direct(src, T, W, out=dst)))
    return out


def measure(n: int, seed: int = 0, device="cuda") -> dict:
    """Every route at width n: ``{name: {"ms", "GBps", "exact",
    "max_abs_err"}}`` (max |dst - src| after one call) and the library copy
    under ``torch_copy`` (its "exact" is its own check)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the copy probe measures the card: device='cuda'")
    rows = 1 << (n - 8)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    src = tuple(torch.rand((rows, 256), generator=g, device=device)
                for _ in range(2))
    dst = tuple(torch.empty_like(x) for x in src)
    res = {}
    for name, s, d, call in routes(src, dst):
        for x in d:
            x.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(s, d))
        # NaN where an element was not written
        err = float(torch.stack([(b - a).abs().max()
                                 for a, b in zip(s, d)]).max())
        ms = _time_ms(call)
        nbytes = 2 * sum(x.numel() * 4 for x in s)
        res[name] = {"ms": ms, "GBps": nbytes / ms / 1e6, "exact": exact,
                     "max_abs_err": err}

    def library():
        for a, b in zip(src, dst):
            b.copy_(a)

    ms = _time_ms(library)
    res["torch_copy"] = {"ms": ms, "GBps": 2 * 2 * rows * 256 * 4 / ms / 1e6,
                         "exact": all(torch.equal(a, b)
                                      for a, b in zip(src, dst))}
    return res


def main(argv=None) -> int:
    widths = [int(a) for a in (argv if argv is not None else sys.argv[1:])]
    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for n in widths or (24, 28, 30):
        res = measure(n)
        best = max((k for k in res if k != "torch_copy"),
                   key=lambda k: res[k]["GBps"])
        print(json.dumps({
            "n": n, "card": card,
            "GBps": {k: v["GBps"] for k, v in res.items()},
            "exact": all(v["exact"] for v in res.values()),
            "best": best, "peak_GBps": PEAK_GBPS}), flush=True)
        if not all(v["exact"] for v in res.values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
