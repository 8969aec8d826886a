"""The port's per-gate ablation strategies (naive, fused2x2, fused3in1,
fused4x4, scan) against the JAX package's engines and the f64 reference,
and their host passes (fuse_2x2, the scan tables) against the JAX
package's."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import scan as JS
from gpu_quantum_simulator_tpu.engine.simulator import Simulator as JSim
from gpu_quantum_simulator_tpu.passes.fuse2x2 import fuse_2x2 as j_fuse_2x2
from gpu_quantum_simulator_tpu.passes.fuse4x4 import fuse_4x4 as j_fuse_4x4
from gpu_quantum_simulator_tpu_torch import Simulator, SimulatorConfig
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.engine import scan as TS
from gpu_quantum_simulator_tpu_torch.ir.oplist import Op
from gpu_quantum_simulator_tpu_torch.passes.fuse2x2 import fuse_2x2
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

STRATEGIES = ["naive", "fused2x2", "fused3in1", "fused4x4", "scan"]
# the JAX package's bars (tests/test_engines.py): a port run against the
# JAX engine's float32 run, and the per-gate engines' f32 random-walk bar
# against the f64 reference
TOL_JAX = 1e-6
TOL_REF = 5e-6
CIRCUITS = {
    "grover_like": (lambda M: M.grover_like(9, 300, 318)),
    "quantum_volume": (lambda M: M.quantum_volume(6, seed=5)),
}


def _port(strategy, c, initial=None, **kw):
    cfg = SimulatorConfig(strategy=strategy, **kw)
    return Simulator(cfg, device="cpu").run_detailed(c, initial=initial)


@pytest.mark.parametrize("family", sorted(CIRCUITS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_jax_and_reference(strategy, family):
    c = CIRCUITS[family](TM)
    res = _port(strategy, c)
    jres = JSim(JConfig(strategy=strategy)).run_detailed(CIRCUITS[family](JM))
    assert np.max(np.abs(res.state - np.asarray(jres.state))) < TOL_JAX
    assert np.max(np.abs(res.state - simulate_reference(c))) < TOL_REF
    assert (res.num_fused_ops, res.strategy) == (jres.num_fused_ops,
                                                 jres.strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_permute_and_initial(strategy):
    """permute=True returns the original basis; ``initial=`` resumes from
    a state given in the original basis (both as the JAX package)."""
    c = TM.random_circuit(7, 120, seed=3)
    rng = np.random.default_rng(9)
    v0 = rng.normal(size=128) + 1j * rng.normal(size=128)
    v0 /= np.linalg.norm(v0)
    want = simulate_reference(c, initial=v0)
    for permute in (False, True):
        got = _port(strategy, c, initial=v0, permute=permute).state
        assert np.max(np.abs(got - want)) < TOL_REF, permute
        jax_got = np.asarray(JSim(JConfig(strategy=strategy, permute=permute))
                             .run(JM.random_circuit(7, 120, seed=3),
                                  initial=v0))
        assert np.max(np.abs(got - jax_got)) < TOL_JAX, permute


def _same_ops(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert (x.kind, tuple(x.qubits)) == (y.kind, tuple(y.qubits))
        if x.u is None:
            assert y.u is None
        else:
            np.testing.assert_allclose(x.u, y.u, rtol=0, atol=1e-12)


@pytest.mark.parametrize("family", sorted(CIRCUITS))
@pytest.mark.parametrize("keep_identity", [False, True])
def test_fuse_2x2_equals_jax(family, keep_identity):
    _same_ops(fuse_2x2(CIRCUITS[family](TM), keep_identity=keep_identity),
              j_fuse_2x2(CIRCUITS[family](JM), keep_identity=keep_identity))


def test_fuse_2x2_skips_identities():
    c = TM.bell()
    c.x(0)
    c.x(0)
    ops = fuse_2x2(c)
    assert [o.kind for o in ops] == ["u", "cx"]
    assert len(fuse_2x2(c, keep_identity=True)) == 3


@pytest.mark.parametrize("family", sorted(CIRCUITS))
@pytest.mark.parametrize("bucket", [1, 64, 256])
def test_build_tables_equal_jax(family, bucket):
    ops = fuse_2x2(CIRCUITS[family](TM))
    jops = j_fuse_2x2(CIRCUITS[family](JM))
    pad = TS.bucket_size(len(ops), bucket)
    assert pad == JS.bucket_size(len(jops), bucket)
    assert pad % bucket == 0 and pad >= len(ops)
    got = TS.build_tables(ops, pad)
    want = JS.build_tables(jops, pad)
    for name in TS.GateTables._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
        assert getattr(got, name).dtype == np.asarray(
            getattr(want, name)).dtype


def test_scan_refuses_wide_ops():
    op = j_fuse_4x4(JM.random_circuit(3, 40, seed=1))
    wide = [o for o in op if o.kind != "cx" and o.width == 2][0]
    port_op = Op("u", tuple(wide.qubits), wide.u)
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="1q/cx ops only, got width 2"):
            mod.build_tables([port_op] if mod is TS else [wide], 4)
    with pytest.raises(ValueError, match="pad_to smaller"):
        TS.build_tables(fuse_2x2(TM.ghz(4)), 1)


def test_scan_bucket_config_runs_its_padding():
    """scan_bucket is the JAX package's field: a bucket of 1 (no padding)
    and of 1024 (mostly identity rows) give the same state."""
    c = TM.grover_like(8, 200, 2)
    a = _port("scan", c, scan_bucket=1).state
    b = _port("scan", c, scan_bucket=1024).state
    assert SimulatorConfig().scan_bucket == JConfig().scan_bucket == 256
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_program_entry_points_take_the_strategy_as_jax(strategy):
    """run_device_parts builds the mxu program for a per-gate strategy,
    run_device_iterated refuses it, and run_many runs it per circuit: the
    JAX package's ``_build_program`` and its entry points."""
    import torch

    sim = Simulator(SimulatorConfig(strategy=strategy), device="cpu")
    c = TM.grover_like(9, 120, 4)
    re, im, nops = sim.run_device_parts(
        c, (torch.ones(512) / 512 ** 0.5, torch.zeros(512)))
    v0 = np.ones(512) / 512 ** 0.5
    got = re.numpy() + 1j * im.numpy()
    assert np.max(np.abs(got - simulate_reference(c, initial=v0))) < TOL_REF
    mxu = Simulator(SimulatorConfig(strategy="mxu"), device="cpu")
    assert nops == mxu.run_device_parts(c, (v0.real, v0.imag))[2]
    with pytest.raises(ValueError, match="run_device_iterated supports"):
        sim.run_device_iterated(c, 2)
    many = sim.run_many([c, TM.ghz(9)])
    np.testing.assert_array_equal(many[0], sim.run(c))
