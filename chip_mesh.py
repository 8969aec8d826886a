#!/usr/bin/env python3
"""The sharded engines with their shards on four cards, against the same
runs with every shard on one card.

    python3 chip_mesh.py        # from the repository root, four CUDA cards

Drives ``strategy="sharded"`` of ``gpu_quantum_simulator_tpu_torch`` (never
JAX) over ``["cuda:0", ..., "cuda:3"]``: the gswaps and half-block
exchanges are then peer copies between cards, each shard's kernels launch
on its own card.  Checks: n=24 at "highest" and "high" over four cards
bit for bit the four-shards-on-one-card run (run times beside each other),
the sampler's indices on the four cards equal to those on one, a
checkpoint saved from four cards reloaded onto two others bit for bit,
complex128 n=20 on the dense engine against mxu's complex128, the dense
engine's small shards (n=10 over eight shards, two a card: shard-index
transpositions move shards between cards) against the f64 reference, and
n=31 over eight shards (two a card): first run, norm, peak memory per
card; and n=34 over four shards, one of 2^32 amplitudes a card (the
benchmark's four-card cell): first run, norm, peak memory per card, the
memory a card keeps once the run has returned (the state alone: the spare
pair is freed), the gswaps, the gswap kernel's launches (one a shard and
gswap) and the bytes they moved between cards (``gswap_peer_bytes``), and
whether every card can read every other's memory; before that run, the
gswap kernel against its plain version (torch view copies) on that
run's shards, bit for bit and timed (chip_smoke.py
``check_gswap_halves``).  Exits non-zero if a check fails.
"""
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import sampling as S
from gpu_quantum_simulator_tpu_torch import telemetry
from gpu_quantum_simulator_tpu_torch.kernels import build
from gpu_quantum_simulator_tpu_torch.parallel.mesh import make_mesh
from gpu_quantum_simulator_tpu_torch.parallel.sharded import join_shards
from gpu_quantum_simulator_tpu_torch.parallel import sharded_prefetch as SP
from gpu_quantum_simulator_tpu_torch.utils import checkpoint as CK
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference
from chip_smoke import check_gswap_halves


def sim(devs, shards, **kw):
    """The sharded strategy over ``shards`` shards on the devices ``devs``."""
    return T.Simulator(T.SimulatorConfig(strategy="sharded",
                                         mesh_shape=(shards,), **kw),
                       device=devs)


def timed(s, c):
    """The second run_device of ``c`` (the first plans): shards, host
    seconds and the first card's device seconds (the chain's events)."""
    SP._RUN_CACHE.clear()
    s.run_device(c)
    t = time.perf_counter()
    re, im, _ = s.run_device(c)
    wall = time.perf_counter() - t
    st, en = list(SP._RUN_CACHE.values())[-1]._chain.events
    return re, im, wall, st.elapsed_time(en) / 1e3


def main() -> int:
    if torch.cuda.device_count() < 4:
        print("chip_mesh: needs four CUDA cards", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.load()
    print(f"built in {time.perf_counter() - t0:.1f} s; cards "
          f"{torch.cuda.device_count()}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    cards = [f"cuda:{i}" for i in range(4)]
    failed = []

    def check(what, cond):
        print(("PASS " if cond else "FAIL ") + what, flush=True)
        if not cond:
            failed.append(what)

    for rung in ("highest", "high"):
        n = 24
        c = T.models.grover_like(n, 2445, 318)
        r1, i1, w1, d1 = timed(sim(["cuda:0"] * 4, 4, precision=rung), c)
        r4, i4, w4, d4 = timed(sim(cards, 4, precision=rung), c)
        one, four = join_shards(r1, i1), join_shards(r4, i4)
        err = float(np.max(np.abs(one - four)))
        print(f"n={n} {rung}: 4 shards on one card run {w1:.3f} s (device "
              f"{d1:.3f}), on four cards {w4:.3f} s (first card's events "
              f"{d4:.3f}); max|diff| {err:.3e}; shards on "
              f"{[str(x.device) for x in r4]}")
        check(f"n={n} {rung}: four cards == one card", err <= 1e-7)
        if rung == "highest":
            for seed in (1, 2):
                check(f"n={n} samples, four cards == one card (seed {seed})",
                      np.array_equal(
                          S.sample_state_device(r4, i4, n, 2000, seed=seed),
                          S.sample_state_device(r1, i1, n, 2000, seed=seed)))
            check(f"n={n} norm", abs(S.norm_device(r4, i4) - 1) < 1e-4)
            with tempfile.TemporaryDirectory() as d:
                CK.save_state_sharded(d, r4, i4, n)
                mesh = make_mesh((2,), ("amp",), ["cuda:2", "cuda:3"])
                lr, li, _ = CK.load_state_sharded(d, mesh=mesh)
                check("checkpoint from four cards onto cuda:2, cuda:3 bit "
                      "for bit",
                      [str(x.device) for x in lr] == ["cuda:2", "cuda:3"]
                      and np.array_equal(join_shards(lr, li), four))
        del r1, i1, r4, i4

    # the dense engine across cards: complex128, and small shards (two
    # shard-index bits exchanged reorder shards between cards)
    c = T.models.grover_like(20, 2445, 318)
    ref = T.Simulator(T.SimulatorConfig(strategy="mxu", dtype="complex128"),
                      device="cuda:0").run(c)
    err = float(np.max(np.abs(sim(cards, 4, dtype="complex128").run(c)
                              - ref)))
    print(f"complex128 n=20 dense over four cards vs mxu complex128: "
          f"{err:.3e}")
    check("complex128 dense over four cards", err <= 1e-9)
    for seed in (3, 4):
        c = T.models.random_circuit(10, 200, seed=seed)
        err = float(np.max(np.abs(sim(cards * 2, 8).run(c)
                                  - simulate_reference(c))))
        print(f"dense n=10 over 8 shards on four cards: {err:.3e}")
        check(f"dense small shards (seed {seed})", err <= 2e-5)

    # n = 31 over 8 shards, two a card (chip_smoke phase 11 runs them on one)
    c = T.models.grover_like(31, 2445, 318)
    for k in range(4):
        torch.cuda.reset_peak_memory_stats(k)
    SP._RUN_CACHE.clear()
    t = time.perf_counter()
    re, im, _ = sim(cards * 2, 8).run_device(c)
    wall = time.perf_counter() - t
    prog = list(SP._RUN_CACHE.values())[-1]
    st, en = prog._chain.events
    peaks = [torch.cuda.max_memory_allocated(k) / 2**30 for k in range(4)]
    norm = S.norm_device(re, im)
    print(f"n=31 over 8 shards on four cards 'high': first run_device "
          f"{wall:.2f} s (planning {prog.build_seconds:.2f} s), first "
          f"card's events {st.elapsed_time(en) / 1e3:.2f} s, norm "
          f"{norm:.8f}, peak GiB per card {[round(p, 3) for p in peaks]}")
    check("n=31 over four cards: norm", abs(norm - 1) < 1e-4)
    del re, im

    # n = 34 over four shards, one a card: the state and its spare pair
    # take 64 GiB of each card
    peers = {(a, b): torch.cuda.can_device_access_peer(a, b)
             for a in range(4) for b in range(4) if a != b}
    print(f"peer access: {peers}")
    check("every card reads every other's memory", all(peers.values()))
    torch.cuda.empty_cache()
    check_gswap_halves(torch, [f"cuda:{k}" for k in range(4)], 1 << 32)
    c = T.models.grover_like(34, 2445, 318)
    for k in range(4):
        torch.cuda.reset_peak_memory_stats(k)
    SP._RUN_CACHE.clear()
    held = [torch.cuda.memory_allocated(k) / 2**30 for k in range(4)]
    before = telemetry.counters()
    t = time.perf_counter()
    re, im, _ = sim(cards, 4).run_device(c)
    wall = time.perf_counter() - t
    after = telemetry.counters()
    prog = list(SP._RUN_CACHE.values())[-1]
    st, en = prog._chain.events
    peaks = [torch.cuda.max_memory_allocated(k) / 2**30 for k in range(4)]
    # what the run left on each card beside what the earlier phases hold
    kept = [torch.cuda.memory_allocated(k) / 2**30 - held[k]
            for k in range(4)]
    norm = S.norm_device(re, im)
    gswaps = after["launches/gswap"] - before["launches/gswap"]
    pulls = (after["launches/gswap_halves"]
             - before["launches/gswap_halves"])
    peer = after.get("gswap_peer_bytes", 0) - before.get("gswap_peer_bytes",
                                                          0)
    print(f"n=34 over 4 shards on four cards 'high': first run_device "
          f"{wall:.2f} s (planning {prog.build_seconds:.2f} s), first "
          f"card's events {st.elapsed_time(en) / 1e3:.2f} s, norm "
          f"{norm:.8f}, peak GiB per card {[round(p, 3) for p in peaks]}, "
          f"kept GiB per card {[round(k, 3) for k in kept]}, {gswaps} "
          f"gswaps, {pulls} gswap kernel launches, {peer / 2**30:.1f} GiB "
          f"between cards")
    check("n=34 over four cards: norm", abs(norm - 1) < 1e-4)
    check("n=34: shards of 2^32 amplitudes, one a card",
          [(x.numel(), str(x.device)) for x in re]
          == [(1 << 32, f"cuda:{k}") for k in range(4)])
    check("n=34: the spare pair is freed when the run returns",
          max(kept) < 32.5)
    check("n=34: every gswap ships half of each shard between cards",
          gswaps > 0 and peer == gswaps * 4 * (1 << 32) * 4)
    check("n=34: the gswap kernel launches once a shard and gswap",
          pulls == 4 * gswaps)
    print("ALL OK" if not failed else f"FAILED: {failed}")
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
