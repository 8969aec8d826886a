"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the cell
(``workloads``) names its configuration (``configs[].file``, a JSON file of
sizes and settings) and its traffic mix (``mixes/<traffic>.json``); the
configuration names its circuit family (``families/<family>.py``) and its
plain reference (``references/<reference>.py``); the mix names its entry
(``entries/<entry>.py``: the call a request makes, what it keeps and how
its answers are judged); each metric is read by ``metrics/<name>.py``, or
by ``metrics/<prefix>.py`` for a name ``<prefix>.<rest>`` without a file of
its own.  A mix may override keys of the configuration's circuit
(``circuit``); the cell's ``chips`` decides the devices the simulator gets.
A new cell, configuration, mix, entry or metric is new files and new
entries; no file here changes.

The traffic is a closed loop with one client: a request is one call into the
simulator's facade (the entry's ``call``), and the next starts when it has
returned.  The window starts a request while the last one's state was ready
before ``--seconds`` had passed, so every circuit counts whole; the window
ends when the last one returns.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_quantum_simulator_tpu")
PORT = "gpu_quantum_simulator_tpu_torch"


# ---------------------------------------------------------------- the spec
def _load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str):
        self.root = root
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))
        self.here = os.path.join(root, "benchmark")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return _json(os.path.join(self.here, "mixes", traffic + ".json"))

    def family(self, config: dict):
        return _load_module(os.path.join(self.here, "families",
                                         config["family"] + ".py"))

    def reference(self, config: dict):
        return _load_module(os.path.join(self.here, "references",
                                         config["reference"] + ".py"))

    def entry(self, mix: dict):
        """``entries/<entry>.py``; an entry without a file is refused."""
        path = os.path.join(self.here, "entries", mix["entry"] + ".py")
        if not os.path.isfile(path):
            raise ValueError(f"the mix names entry {mix['entry']!r}, and "
                             f"benchmark/entries/{mix['entry']}.py is "
                             "missing")
        return _load_module(path)

    def reader(self, name: str):
        """``metrics/<name>.py``, else ``metrics/<prefix>.py`` for a name
        ``<prefix>.<rest>``: one reader serves a quantity split by the
        end-to-end metric it moves."""
        for stem in (name, name.split(".")[0]):
            path = os.path.join(self.here, "metrics", stem + ".py")
            if os.path.isfile(path):
                return _load_module(path)
        raise ValueError(f"no reader for metric {name!r} in "
                         "benchmark/metrics/")

    def metrics(self, cell: str, traced: bool):
        """[(metric entry, reader)] that this cell reports: the end-to-end
        metrics untraced, the per-layer ones traced.  A metric with a
        ``workloads`` key is reported in those cells; a per-layer one
        without it wherever its ``moves`` metric is."""
        e2e = self.bench["end_to_end"]

        def listed(m):
            return "workloads" not in m or cell in m["workloads"]

        mine = {m["name"] for m in e2e if listed(m)}
        if traced:
            chosen = [m for m in self.bench["per_layer"]
                      if (cell in m["workloads"] if "workloads" in m
                          else m["moves"] in mine)]
        else:
            chosen = [m for m in e2e if listed(m)]
        return [(m, self.reader(m["name"])) for m in chosen]


# ------------------------------------------------------------- the traffic
def _seed_int(*entropy) -> int:
    """A 63-bit seed drawn from ``entropy`` (whole numbers >= 0)."""
    ss = np.random.SeedSequence([int(x) for x in entropy])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_traffic(cell, draw):
    """(warm-up gate list, [gate lists of the window], [sampling seeds]),
    the mix's ``circuits``: "same" runs one circuit again and again (the
    warm-up is that circuit); "new" gives every request a circuit of its
    own, ``prepared`` of them made before the window, the warm-up another.
    ``draw(*tags)`` is the family's gate list for the run's seed and the
    tags.  An entry with traffic of another shape defines ``traffic(cell,
    draw)`` itself."""
    seed, mix = cell.seed, cell.mix
    if mix["circuits"] == "same":
        one = draw(0)
        return one, [one], [_seed_int(seed, 3, 0)]
    if mix["circuits"] != "new":
        raise ValueError(f"circuits {mix['circuits']!r}: \"same\" or "
                         "\"new\", or an entry with a traffic() of its own")
    count = int(mix["prepared"])
    return (draw(2), [draw(1, i) for i in range(count)],
            [_seed_int(seed, 3, i) for i in range(count)])


def to_circuit(gate_list, num_qubits: int):
    """The port's ``Circuit``, built through its public ``append`` with
    every gate's name, qubits and parameters."""
    from gpu_quantum_simulator_tpu_torch import Circuit

    c = Circuit(num_qubits)
    for name, qubits, params in gate_list:
        c.append(name, *qubits, params=params)
    return c


class Capture:
    """What an entry keeps of a request besides its answer; this one keeps
    nothing.  ``deadline`` is when the window closes, ``ready`` the host
    clock at which the last request's state was ready (None: at its
    return), ``state`` what was kept for the check.  An entry module may
    define its own ``Capture``."""

    def __init__(self):
        self.deadline = math.inf
        self.ready = None
        self.state = None

    @contextlib.contextmanager
    def installed(self):
        yield self


# ------------------------------------------------------------------ a run
class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def devices(device: str, chips: int):
    """What the simulator runs on: ``device`` for one chip, else a list of
    ``chips`` devices ("cuda:0".., or ``device`` repeated off the card)."""
    if chips == 1:
        return device
    if device.startswith("cuda"):
        return [f"cuda:{i}" for i in range(chips)]
    return [device] * chips


class Cell:
    """A cell made ready to run: its simulator, its circuits and its seeds.
    ``device`` is "cuda" on the card (tests pass "cpu"); ``overrides``
    changes fields of the simulator's configuration (the control)."""

    def __init__(self, spec: Spec, workload: str, seed: int, device: str,
                 overrides=None):
        from gpu_quantum_simulator_tpu_torch import Simulator, SimulatorConfig

        cell = spec.cell(workload)
        self.spec, self.seed, self.ref_device = spec, seed, device
        self.chips = int(cell["chips"])
        self.config, self.mix = spec.config(cell["config"]), spec.mix(
            cell["traffic"])
        self.n = self.config["num_qubits"]
        self.entry = spec.entry(self.mix)
        self.sim = Simulator(SimulatorConfig(
            **{**self.config["simulator"], **(overrides or {})}),
            device=devices(device, self.chips))
        family = spec.family(self.config)
        # the mix's "circuit" overrides keys of the configuration's circuit
        # (a structure drawn anew each request, say); sizes stay the
        # configuration's
        drawn = {**self.config, **self.mix.get("circuit", {})}

        def draw(*tags):
            return family.gates(drawn, [seed, *tags])

        build = getattr(family, "to_circuit", to_circuit)
        traffic = getattr(self.entry, "traffic", make_traffic)
        warm, self.gates, self.sample_seeds = traffic(self, draw)
        self.warm = build(warm, self.n)
        self.circuits = [build(g, self.n) for g in self.gates]

    @property
    def name(self) -> str:
        return self.mix["entry"]

    def capture(self):
        return getattr(self.entry, "Capture", Capture)()

    def call(self, c, i: int):
        """One request: the answer the user takes back."""
        return self.entry.call(self, c, i)

    def judge(self, answers, kept):
        """(numbers compared, each beside its limit; answers failed), by
        the entry's ``judge`` against the configuration's reference."""
        numbers, failed = self.entry.judge(
            self, answers, kept, self.spec.reference(self.config))
        limits = {**self.config["limits"], **self.mix.get("limits", {})}
        return ({k: {"value": float(v), "limit": float(limits[k])}
                 for k, v in numbers.items()}, failed)


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             traced: bool, device: str, t_start: float, overrides=None,
             log=print):
    """Run the cell and return (result line as a dict, checks).  Raises
    SystemExit, with no result, where JAX or the JAX package was loaded by
    the time the line is made."""
    import torch

    cell = Cell(spec, workload, seed, device, overrides)
    cuda = device.startswith("cuda")
    capture = cell.capture()
    with capture.installed():
        cell.call(cell.warm, 0)
        if cuda:
            for d in range(cell.chips):
                torch.cuda.synchronize(d)
        prof = _profiler(torch, cuda) if traced else None
        if prof is not None:
            prof.__enter__()
        setup_s = time.perf_counter() - t_start
        capture.deadline = time.perf_counter() + seconds
        answers, spans = [], []
        while not spans or spans[-1][2] < capture.deadline:
            i = len(spans)
            if i == len(cell.circuits) and i > 1:
                log(f"repeat: the window needs more than the {i} circuits "
                    "made before it; they are run again")
            capture.ready = None
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"{cell.name}#{i}"):
                answers.append(cell.call(cell.circuits[i % len(
                    cell.circuits)], i))
            t1 = time.perf_counter()
            spans.append((t0, t1, t1 if capture.ready is None
                          else capture.ready))
        window_s = spans[-1][1] - spans[0][0]
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = (max(torch.cuda.max_memory_allocated(d)
                for d in range(cell.chips)) if cuda else 0)
    kept = capture.state
    trace = (_trace_view(spec, prof, cell.n, cell.chips)
             if prof is not None else None)
    cell.sim = capture = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the peak has been read
    t_ref = time.perf_counter()
    checks, failed = cell.judge(answers, kept)
    del kept, answers
    log(f"reference and check: {time.perf_counter() - t_ref:.3f} s")
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    record = Run(setup_s=setup_s, window_s=window_s, requests=spans,
                 trace=trace, config=cell.config, mix=cell.mix)
    metrics = {}
    for m, reader in spec.metrics(workload, traced):
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(spans),
              "failed": failed, "metrics": metrics,
              "device": _device(torch, cuda, cell.chips, peak, trace)}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
        log(f"unmapped hand kernels: {sorted(trace.unmapped()) or 'none'}")
    log(f"window: {len(spans)} requests in {window_s:.6f} s ("
        + ", ".join(f"{t1 - t0:.4f}" for t0, t1, _ in spans)
        + f" s each); set-up {setup_s:.6f} s; peak device memory {peak} "
        "bytes")
    result["checks"] = checks
    refuse_forbidden()
    return result, checks


def refuse_forbidden() -> None:
    """SystemExit, naming them, where modules of JAX or the JAX package
    are loaded: the reference, the entries and the metric readers have all
    run by the time a result is made."""
    found = loaded_forbidden()
    if found:
        raise SystemExit("no result: modules of JAX or the JAX package "
                         f"were loaded: {', '.join(found)}")


def _profiler(torch, cuda):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _trace_view(spec: Spec, prof, n: int, chips: int):
    from .roofline import KernelTable
    from .tracing import TraceView, hand_kernels, read_trace

    path = os.path.join(spec.root, "build", "benchmark", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        events = read_trace(path)
    finally:
        os.remove(path)
    return TraceView(events, hand_kernels(os.path.join(spec.root, PORT,
                                                       "csrc")),
                     KernelTable(os.path.join(spec.here, "kernels")), n,
                     chips)


def _device(torch, cuda, chips, peak, trace) -> dict:
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
    return dev
