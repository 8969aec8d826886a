"""The port's prefetch slice end to end, against the JAX package.

``Simulator(strategy="prefetch", device="cpu")`` of the port (each kernel's
plain torch version) against the JAX package's prefetch Simulator
(interpret-mode Pallas) and its f64 ``simulate_reference``, with the JAX
prefetch tests' tolerance; the same numpy tables fed to both engines'
chains; and the raises that fence the slice.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import prefetch as JPF
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSimulator
from gpu_quantum_simulator_tpu.ref.cpu import simulate_reference

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline

TOL = 2e-5   # tests/test_prefetch.py TOL


def _port(**kw):
    return T.Simulator(T.SimulatorConfig(strategy="prefetch", **kw),
                       device="cpu")


def _jax():
    return JSimulator(JConfig(strategy="prefetch"))


@pytest.fixture
def tiles(monkeypatch):
    def set_tiles(t, tr):
        for pf in (JPF, TPF):
            monkeypatch.setattr(pf, "TILE_ROWS", t)
            monkeypatch.setattr(pf, "RELAYOUT_TILE_ROWS", tr)
        _clear()

    def _clear():
        for cache in (JPF._KERNEL_CACHE, JPF._CHAIN_CACHE, JPF._PROGRAM_CACHE,
                      JPF._RUN_CACHE, TPF._PROGRAM_CACHE, TPF._RUN_CACHE):
            cache.clear()

    yield set_tiles
    _clear()


@pytest.mark.parametrize("n,gates,seed", [(9, 120, 0), (11, 300, 3), (12, 400, 7)])
def test_port_matches_jax_and_reference(n, gates, seed):
    c = T.models.grover_like(n, gates, seed)
    jc = JM.grover_like(n, gates, seed)
    got = _port().run_detailed(c)
    want = _jax().run_detailed(jc)
    ref = simulate_reference(jc)
    assert got.state.shape == (1 << n,) and got.state.dtype == np.complex64
    assert got.num_fused_ops == want.num_fused_ops
    assert np.max(np.abs(got.state - want.state)) < TOL
    assert np.max(np.abs(got.state - ref)) < TOL


def test_prologue_and_relayout_entries(tiles):
    """4-row tiles and 1-row relayout blocks: n=12 plans both steered
    prologues and relayout entries, and the port runs them exactly."""
    tiles(4, 1)
    n = 12
    c = T.models.grover_like(n, 300, 13)
    jc = JM.grover_like(n, 300, 13)
    got = _port().run(c)
    (prog,) = TPF._RUN_CACHE.values()
    modes = {row[1] for scal, *_ in prog._chain._parts for row in scal}
    assert {1, 3} <= modes, modes
    assert np.max(np.abs(got - _jax().run(jc))) < TOL
    assert np.max(np.abs(got - simulate_reference(jc))) < TOL


def test_same_tables_through_both_chains(tiles):
    """``program_from_entries`` and the JAX chain run one set of numpy
    tables (the port's own ``materialize_entries``) on one random state."""
    tiles(4, 1)
    n = 12
    c = T.models.grover_like(n, 400, 7)
    ops = _fuse_pipeline(c, 7, max_high=2, window=8)
    plan = TPF.plan_prefetch(ops, n)
    entries = TPF.materialize_entries(plan.blocks, TPF.CAP_STEPS,
                                      TPF.CAP_MATS, np.float32)
    assert plan.num_relayouts > 0 and plan.num_xswaps > 0
    rng = np.random.default_rng(5)
    v = rng.standard_normal((2, 1 << n)).astype(np.float32)

    got = TPF.program_from_entries(entries, n, "cpu")(
        torch.from_numpy(v[0].copy()), torch.from_numpy(v[1].copy()))

    re, im = jnp.asarray(v[0]), jnp.asarray(v[1])
    ptab = JPF.perm_table(np.float32)
    for cap, sizes, scal, *tabs in entries:
        off = 0
        for size in sizes:
            part = [jnp.asarray(t[off : off + size]) for t in tabs]
            a_tab, b_tab = JPF._get_expander(size, cap, np.float32)(*part)
            chain = JPF.get_block_chain(n, np.float32, "highest", True, size,
                                        cap_mats=cap)
            re, im = chain(re, im, jnp.asarray(scal[off : off + size]),
                           a_tab, b_tab, ptab)
            off += size
    assert np.max(np.abs(got[0].numpy() - np.asarray(re))) < 1e-5
    assert np.max(np.abs(got[1].numpy() - np.asarray(im))) < 1e-5


def test_initial_state_resume():
    """A prefix then a resumed suffix equals the whole circuit."""
    n = 10
    full = T.models.grover_like(n, 200, 31)
    first, second = T.Circuit(n), T.Circuit(n)
    first.gates = full.gates[:100]
    second.gates = full.gates[100:]
    sim = _port()
    got = sim.run(second, initial=sim.run(first))
    want = simulate_reference(JM.grover_like(n, 200, 31))
    assert np.max(np.abs(got - want)) < TOL


def test_auto_resolves_to_prefetch():
    c = T.models.ghz(10)
    got = T.simulate(c, device="cpu")
    assert abs(got[0] - 2 ** -0.5) < TOL and abs(got[-1] - 2 ** -0.5) < TOL
    res = T.Simulator(T.SimulatorConfig(strategy="auto"),
                      device="cpu").run_detailed(c)
    assert res.strategy == "prefetch"


@pytest.mark.parametrize("kind", ["n8", "n30", "inplace10", "pallas7",
                                  "inplace"])
def test_outside_the_slice_raises(kind):
    # Every rung runs; complex128 is refused by the float32-only engines at
    # every width, before anything is planned or allocated: prefetch at
    # n = 8 (its megakernel arm), at n = 30 (in place by default) and in
    # place at n = 10, as in the JAX package, and pallas on its megakernel
    # arm at n = 7; the halves of a flat run do not exist ("inplace").
    n = {"n8": 8, "n30": 30, "pallas7": 7}.get(kind, 10)
    c = T.models.grover_like(n, 40, 1)
    kw = {"n30": dict(dtype="complex128", precision="default"),
          "inplace10": dict(dtype="complex128", prefetch_inplace=True),
          "pallas7": dict(strategy="pallas", dtype="complex128"),
          "n8": dict(dtype="complex128"),
          "inplace": dict(prefetch_inplace=False)}[kind]
    sim = T.Simulator(T.SimulatorConfig(**{"strategy": "prefetch", **kw}),
                      device="cpu")
    exc, match = {"inplace": (ValueError, "in-place engine")}.get(
        kind, (ValueError, "float32-only"))
    TPF._RUN_CACHE.clear()
    with pytest.raises(exc, match=match):
        sim.run_device_halves(c) if kind == "inplace" else sim.run(c)
    assert not TPF._RUN_CACHE            # nothing was planned or built


def test_no_port_message_cites_a_roadmap_item_by_number():
    """The port's messages and docstrings name a ROADMAP item by its queue
    and title, never by a number ("queue A, item 5"): the numbers move
    when the queues are re-ordered, the titles do not."""
    import os
    import re

    port = os.path.dirname(T.__file__)
    cited = re.compile(r"ROADMAP[^.]{0,80}?\bitems? \d", re.S)
    files = [os.path.join(root, f) for root, _, names in os.walk(port)
             for f in names if f.endswith((".py", ".cu", ".cuh"))]
    bad = [os.path.relpath(f, port) for f in files
           if cited.search(open(f).read())]
    assert len(files) > 40 and not bad, bad


def test_no_stub_is_left_for_ported_modules():
    """No NotImplementedError in the port names ``ir/decompose.py``,
    ``observables.py``, the QASM front-end, "Workloads on the state" or
    ``dynamic.py`` (all are ported), and ``Circuit.initialize``,
    ``pauli_rot`` and ``unitary`` run."""
    import ast
    import os

    port = os.path.dirname(T.__file__)
    stale = []
    for root, _, names in os.walk(port):
        for f in names:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.Raise) and node.exc is not None:
                    text = ast.unparse(node.exc)
                    if "NotImplementedError" in text and any(
                            w in text for w in ("decompose", "observables",
                                                "QASM front-end", "qasm",
                                                "Workloads on the state",
                                                "dynamic.py")):
                        stale.append((os.path.relpath(path, port),
                                      node.lineno))
    assert not stale, stale
    c = T.Circuit(3).initialize(np.ones(8) / 8 ** 0.5)
    c.pauli_rot(0.3, "X0 Z2").unitary(np.eye(4), 0, 1)
    assert len(c.gates) > 8


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.Simulator(T.SimulatorConfig(strategy="prefetch"), device="cuda")
