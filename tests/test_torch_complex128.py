"""complex128 in the port: the JAX package's float64 parity arms.

``SimulatorConfig(dtype="complex128")`` runs mxu (every block a float64
``torch.matmul`` Karatsuba step between row shuffles, as the JAX package
runs its kh = 0 blocks outside Pallas below float32), the megakernel, the
per-gate engines and ``reference`` in float64 from the tables to the
result.  Each is held to the f64 reference at 1e-9
(tests/test_engines.py:69-74) and to the JAX package's complex128 run at
1e-12 (both float64: only the sums' order differs).  prefetch, pallas and
vmem refuse it with a ValueError naming the float64 arms.
"""

import numpy as np
import pytest
import torch

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import simulator as JS

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import megakernel as TM
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine import simulator as TS
from gpu_quantum_simulator_tpu_torch.engine import wide as TW
from gpu_quantum_simulator_tpu_torch.ops import apply as TA
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

F64_TOL = 1e-9      # tests/test_engines.py:69-74's bar against f64
JAX_TOL = 1e-12     # two float64 runs, sums in another order
ARMS = ("mxu", "megakernel", "naive", "fused2x2", "fused3in1", "fused4x4",
        "scan", "reference")


def _sim(strategy, **kw):
    return T.Simulator(T.SimulatorConfig(strategy=strategy,
                                         dtype="complex128", **kw),
                       device="cpu")


@pytest.mark.parametrize("strategy", ARMS)
def test_complex128_matches_f64_and_jax(strategy):
    n = 10
    c = T.models.grover_like(n, 300, seed=41)
    got = _sim(strategy).run(c)
    assert got.dtype == np.complex128
    assert np.max(np.abs(got - simulate_reference(c))) <= F64_TOL
    want = np.asarray(JS.Simulator(JConfig(
        strategy=strategy, dtype="complex128")).run(
            JM.grover_like(n, 300, seed=41)))
    assert np.max(np.abs(got - want)) <= JAX_TOL


def test_mxu_complex128_is_float64_throughout():
    """No float32 round trip: the program plans no chain (kh = 0 blocks are
    D = 128 matmul steps, as in the JAX package below float32), its tables
    are float64, the rung is not read, and the result is within 1e-12 of
    the f64 reference, which a float32 rounding anywhere would miss."""
    n = 10
    c = T.Circuit(n)      # kh = 0 runs and mm steps (test_torch_wide mixed)
    for i, g in enumerate(T.models.grover_like(7, 260, 41).gates):
        c.gates.append(g)
        if i % 40 == 39:
            c.cx(7, 8).cx(8, 9).h(7)
    ops = TS._fuse_pipeline(c, 7, max_high=2, window=8)
    prog = TW.WideProgram(ops, n, precision="default", device="cpu",
                          dtype=torch.float64)
    steps = [st for seg in prog.segments for st in seg.steps]
    assert prog.num_kh0_runs == 0 and prog.precision == "highest"
    assert any(st[1] == 128 for st in steps) and all(
        st[0] == "mm" for st in steps)
    assert all(t.dtype == torch.float64 for seg in prog.segments
               for t in seg.mm.values())
    ref = simulate_reference(c)
    for rung in ("highest", "high", "default"):
        got = _sim("mxu", precision=rung).run(c)
        assert np.max(np.abs(got - ref)) <= JAX_TOL
    fn = TM.build_megakernel(ops, n, device="cpu", dtype=torch.float64)
    re, im = fn(*TA.initial_state_parts(n, dtype=torch.float64,
                                        device="cpu"))
    assert re.dtype == torch.float64
    assert np.max(np.abs(re.numpy() + 1j * im.numpy() - ref)) <= JAX_TOL


@pytest.mark.parametrize("strategy", ["mxu", "megakernel"])
def test_complex128_program_entry_points(strategy):
    """run_device_iterated returns float64 (tests/test_engines.py:101-112),
    run_device_parts keeps float64 parts, run_many and sample run."""
    n = 9
    body = T.models.grover_like(n, 60, seed=3)
    sim = _sim(strategy)
    re, im, nops = sim.run_device_iterated(body, 3)
    assert re.dtype == torch.float64 and im.dtype == torch.float64
    unrolled = T.Circuit(n)
    unrolled.gates = body.gates * 3
    ref = simulate_reference(unrolled)
    assert np.max(np.abs(re.numpy() + 1j * im.numpy() - ref)) <= F64_TOL

    first = simulate_reference(body)
    pre, pim, _ = sim.run_device_parts(body, (first.real, first.imag))
    assert pre.dtype == torch.float64
    two = T.Circuit(n)
    two.gates = body.gates * 2
    assert np.max(np.abs(pre.numpy() + 1j * pim.numpy()
                         - simulate_reference(two))) <= F64_TOL

    many = sim.run_many([body, two])
    assert all(v.dtype == np.complex128 for v in many)
    assert np.max(np.abs(many[1] - simulate_reference(two))) <= F64_TOL
    samples = sim.sample(body, 500, seed=1)
    assert samples.shape == (500,) and samples.max() < (1 << n)


@pytest.mark.parametrize("strategy", ["prefetch", "pallas", "vmem", "auto"])
@pytest.mark.parametrize("n", [7, 12])
def test_float32_only_engines_refuse_complex128(strategy, n):
    """prefetch (as in the JAX package), pallas and vmem refuse complex128
    at every width, naming the float64 arms, before planning anything."""
    c = T.models.grover_like(n, 40, 1)
    TPF._RUN_CACHE.clear()
    TS._MXU_PLAN_CACHE.clear()
    with pytest.raises(ValueError, match="float32-only") as err:
        _sim(strategy).run(c)
    assert "mxu" in str(err.value) and "megakernel" in str(err.value) \
        and "reference" in str(err.value)
    assert not TPF._RUN_CACHE and not TS._MXU_PLAN_CACHE
