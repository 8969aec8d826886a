"""One layout-closed program, captured once as a CUDA graph and replayed.

The port's counterpart of the JAX package's one-dispatch iterated arms:
``engine/simulator.py`` ``_scan_program`` (a ``lax.scan`` over a
WideProgram's pure chain) and ``engine/prefetch.py`` ``iterate_program``
(a ``lax.scan`` over a flat PrefetchProgram's chain).  Here the program's
launch chain, as its ``__call__`` issues it, is captured once into a
``torch.cuda.CUDAGraph`` and each repetition is one ``replay``: no
planning, table upload, allocation or Python step loop per repetition.

The graph reads and writes one static state pair that it owns.  The
program writes into the pair it is handed and may leave its result in
a second pair it allocates (in the graph's private pool); the capture
then ends with one pair copy back into the static pair, so that every
replay maps the static pair to itself.  A call copies the caller's state
in and the result out, so the caller's tensors are never changed and the
result is never the graph's buffer.

Before the capture the program runs once eagerly on a copy of the state,
on the capture stream: the launchers' one-time host setup
(shared-memory attributes, persistent-slot counts) and cuBLAS's
workspace for that stream are made outside the graph.  A capture or a
replay that fails raises; nothing falls back to an eager loop.  Only the
eager loop runs on the CPU, where the caller asked for it.

One graph is live per device: its static pair and private pool are about
two states, so a sweep over many bodies (a QAOA angle scan) keeps one
graph, not one per program.  Capturing another program drops the live
one first.

The kernel wrappers count their launches (``<wrapper>.launches``, read
through ``telemetry.launch_counts``).  A capture launches nothing, so
what the wrappers counted while it recorded is taken back, and every
replay adds it once.
"""

from __future__ import annotations

import torch

from ..telemetry import launch_counts

# one capture stream per device, reused: its cuBLAS workspace is made
# once, by the first warm-up
_STREAMS: dict = {}
# the live graph of each device
_LIVE: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def add_launches(delta: dict, times: int) -> None:
    """Add ``times`` x ``delta`` (a difference of two ``launch_counts``) to
    the wrappers' counts."""
    for (fn, kind), v in delta.items():
        if kind is None:
            fn.launches += v * times
        else:
            fn.launches[kind] += v * times


class ProgramGraph:
    """``prog`` (a (re, im) -> (re, im) program on flat state pairs)
    captured for states shaped like ``re``.  ``launches``: what one replay
    launches, by wrapper and kind."""

    def __init__(self, prog, re: torch.Tensor, im: torch.Tensor):
        dev = re.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA state, got {dev}")
        self.prog = prog
        self.re = torch.empty_like(re)
        self.im = torch.empty_like(im)
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            warm = prog(re.clone(), im.clone())
            del warm
        stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(self.graph, stream=stream):
            out_re, out_im = prog(self.re, self.im)
            for out, mine in ((out_re, self.re), (out_im, self.im)):
                if out.data_ptr() != mine.data_ptr():
                    mine.copy_(out.reshape(mine.shape))
            del out_re, out_im, out
        after = launch_counts()
        self.launches = {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}
        add_launches(self.launches, -1)

    def __call__(self, re: torch.Tensor, im: torch.Tensor, repetitions: int):
        """``prog``^repetitions of (re, im) as a new pair; the inputs are
        not changed."""
        self.re.copy_(re)
        self.im.copy_(im)
        for _ in range(repetitions):
            self.graph.replay()
        add_launches(self.launches, repetitions)
        return self.re.clone(), self.im.clone()


def graph_of(prog, re: torch.Tensor, im: torch.Tensor) -> ProgramGraph:
    """The device's live graph if it holds ``prog`` for this state shape;
    else ``prog`` captured as the new live graph, the previous one dropped
    (and its memory returned to the card) first."""
    dev = re.device
    g = _LIVE.get(dev)
    if g is not None and g.prog is prog and g.re.shape == re.shape:
        return g
    if g is not None:
        del g
        release()
    g = _LIVE[dev] = ProgramGraph(prog, re, im)
    return g


def release() -> None:
    """Drop every device's live graph and return its static pair and pool
    to the card."""
    if _LIVE:
        _LIVE.clear()
        torch.cuda.empty_cache()


def refuse_inplace(prog) -> None:
    """The JAX package's guard: only a double-buffered program iterates."""
    if getattr(prog, "inplace", False):
        raise ValueError("iterate_program requires the double-buffered "
                         "program (inplace=False)")


def iterate(prog, re: torch.Tensor, im: torch.Tensor, repetitions: int):
    """``prog`` applied ``repetitions`` times to (re, im): graph replays on a
    card, the eager loop on the CPU.  The JAX package's ``lax.scan`` arms
    over a WideProgram (its ``_scan_program``) and a flat PrefetchProgram
    (``iterate_program``); the in-place program is refused, as there."""
    refuse_inplace(prog)
    if re.device.type == "cpu":
        for _ in range(repetitions):
            re, im = prog(re, im)
        return re, im
    return graph_of(prog, re, im)(re, im, repetitions)
