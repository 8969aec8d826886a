"""The traced window, read from ``torch.profiler``'s trace.

The harness opens one span a request (``torch.profiler.record_function``,
named ``<entry>#<index>``) around each call into the simulator's facade;
the profiler puts those spans and the card's events (kernels, copies,
fills) on one clock.  ``TraceView`` holds what the per-layer metrics read:
the window (first request's start to last request's end), each request's
span, and the device events inside the window.

The busy time is the union of the device events' intervals, the arithmetic
of ``gpu_quantum_simulator_tpu_torch/profiling.py`` (``_device_profile``),
copied here so that the yardstick stays fixed.
"""

from __future__ import annotations

import json
import os
import re

from .roofline import KernelTable, parse_kernel

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = re.compile(r"^([\w.-]+)#(\d+)$")
_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+|__\w+__\s*\([^()]*\)\s*)*(\w+)\s*[<(]")


def hand_kernels(csrc_dir: str) -> set:
    """Names of the program's own CUDA kernels: every ``__global__``
    function in its sources."""
    names = set()
    for fname in sorted(os.listdir(csrc_dir)):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc_dir, fname)) as f:
                names.update(_GLOBAL.findall(f.read()))
    return names


def merged(spans):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(spans))


class TraceView:
    """``events``: chrome-trace events (dicts with ``cat``, ``name``,
    ``ts`` and ``dur`` in microseconds, a device event's card in
    ``args.device``).  ``hand``: the program's kernel names; ``table``: the
    kernel table; ``num_qubits``: the state's width; ``chips``: the cards
    the run uses, over which the busy time is averaged."""

    def __init__(self, events, hand: set, table: KernelTable,
                 num_qubits: int, chips: int = 1):
        spans = []
        for e in events:
            m = SPAN.match(e.get("name", ""))
            if e.get("cat") == "user_annotation" and m:
                spans.append((int(m.group(2)), m.group(1), float(e["ts"]),
                              float(e["ts"]) + float(e["dur"])))
        spans.sort()
        self.requests = [(entry, s, e) for _, entry, s, e in spans]
        if not self.requests:
            raise ValueError("the trace holds no request span")
        self.start = self.requests[0][1]
        self.end = self.requests[-1][2]
        inside = [e for e in events if e.get("cat") in DEVICE_CATS
                  and self.start <= float(e["ts"]) <= self.end]
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e["cat"]) for e in inside)
        self.cards: dict = {}
        for e in inside:
            self.cards.setdefault(e.get("args", {}).get("device", 0),
                                  []).append((float(e["ts"]),
                                              float(e["ts"])
                                              + float(e["dur"])))
        self.chips = chips
        self.hand = hand
        self.table = table
        self.num_qubits = num_qubits

    # ---------------------------------------------------------- the window
    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Seconds in which an operation ran on a card, the mean over the
        run's cards."""
        return sum(union_us((s, min(e, self.end)) for s, e in spans)
                   for spans in self.cards.values()) / 1e6 / self.chips

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernels(self):
        return [ev for ev in self.device if ev[3] == "kernel"]

    def is_hand(self, name: str) -> bool:
        return parse_kernel(name)[0] in self.hand

    def hand_launches(self):
        return [ev for ev in self.kernels() if self.is_hand(ev[2])]

    # ------------------------------------------------------------ kernels
    def kernel_roofline_pct(self):
        """100 x the hand launches' least time over their device time; None
        where no hand kernel ran."""
        least = spent = 0.0
        for s, e, name, _ in self.hand_launches():
            least += self.table.least_s(name, self.num_qubits)[0]
            spent += (e - s) / 1e6
        return 100.0 * least / spent if spent > 0 else None

    def unmapped(self) -> set:
        return {parse_kernel(n)[0] for _, _, n, _ in self.hand_launches()
                if not self.table.least_s(n, self.num_qubits)[1]}

    # ----------------------------------------------------------- requests
    def per_request(self):
        """(entry, span start, span end, first hand launch start, last hand
        launch end) a request; the launch times None where none ran."""
        launches = self.hand_launches()
        out = []
        for entry, s, e in self.requests:
            inside = [(a, b) for a, b, _, _ in launches if s <= a <= e]
            out.append((entry, s, e, min(a for a, _ in inside)
                        if inside else None,
                        max(b for _, b in inside) if inside else None))
        return out

    def lead_ms(self):
        """Mean time from a request's start to its first hand launch."""
        leads = [(f - s) / 1e3 for _, s, _, f, _ in self.per_request()
                 if f is not None]
        return sum(leads) / len(leads) if leads else None

    def tail_ms(self):
        """Mean time from a request's last hand launch's end to its return."""
        tails = [(e - last) / 1e3 for _, _, e, _, last in self.per_request()
                 if last is not None]
        return sum(tails) / len(tails) if tails else None

    # ---------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the request open then and where in it."""
        by_name: dict = {}
        for s, e, name, cat in self.device:
            key = parse_kernel(name)[0] if cat == "kernel" else name
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged((s, min(e, self.end)) for s, e, _, _ in self.device)
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = []
        reqs = self.per_request()
        cuts = sorted({t for _, s, e in self.requests for t in (s, e)})
        for a, b in zip(edges[0::2], edges[1::2]):
            # a gap that spans a request's start or end is cut there
            inner = [t for t in cuts if a < t < b]
            for lo, hi in zip([a] + inner, inner + [b]):
                if hi > lo:
                    gaps.append((self._label(lo, hi, reqs), (hi - lo) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps[:top]]}

    @staticmethod
    def _label(a, b, reqs) -> str:
        for i, (entry, s, e, first, last) in enumerate(reqs):
            if s <= a < e:
                if first is None or b <= first:
                    where = "before its first launch"
                elif last is not None and a >= last:
                    where = "after its last launch"
                else:
                    where = "between its launches"
                return f"{entry}#{i} {where}"
        return "between requests"


def read_trace(path: str):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
