"""The "default" precision rung of the port against the JAX package.

"default" is one bf16 pass: ``jnp.dot(..., precision=DEFAULT)`` on float32
operands rounds both to bf16 on the TPU and sums the products in fp32.  On
the CPU XLA computes such dots in full fp32 (tests/test_precision_auto.py),
so the JAX package's run here is no bit-level reference for the rung.  The
rung's arithmetic is held instead to the one-pass emulation
``jnp.dot(x.astype(bfloat16), m.astype(bfloat16),
preferred_element_type=float32)`` (the first term of the JAX package's own
``_make_dot("high")``), product for product, at 1e-6 of the output's
largest magnitude (the sums' order differs); and on bf16-exact operands,
where the "high" rung's corrections are exact zeros, the port's "default"
plain versions equal its "high" ones bit for bit.  Whole runs must err
against the f64 reference by more than 1e-6 (the rounding ran) and by no
more than the rung's bar.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig
from gpu_quantum_simulator_tpu.engine import simulator as JS
from gpu_quantum_simulator_tpu.engine import wide as JW

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine import simulator as TS
from gpu_quantum_simulator_tpu_torch.engine import wide as TW
from gpu_quantum_simulator_tpu_torch.kernels import block as KB
from gpu_quantum_simulator_tpu_torch.kernels import split as KS
from gpu_quantum_simulator_tpu_torch.kernels import wide as KW
from gpu_quantum_simulator_tpu_torch.ops import apply as TA
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

ONE_PASS_REL = 1e-6   # plain version vs the jnp one-pass emulation, of the
                      # output's largest |value|: the same bf16 operands and
                      # exact products, fp32 sums in another order
RUNG_FLOOR = 1e-6     # a "default" run errs by more: the rounding ran
RUNG_BAR = 1e-3       # and by at most this against f64 on grover_like(12,
                      # 600, 41), whose peak |amplitude| is 0.0486
BAR_PEAK = 0.0486
# mxu computes Karatsuba (t1 - t3 of operands rounded to bf16 once each:
# s = re + im and the combinations M_im - M_re, M_re + M_im), whose one
# pass rounds two more operands than the schoolbook mat step's; its bar
# is the schoolbook one doubled, scaled with the state's peak |amplitude|
# as the rung bars of tests/test_torch_wide.py are
KARATSUBA_BAR = 2 * RUNG_BAR


def _bf(x):
    return jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16)


def one_pass(x, m):
    """The TPU's DEFAULT dot on float32 operands, emulated in jnp."""
    return np.asarray(jnp.dot(_bf(x), _bf(m),
                              preferred_element_type=jnp.float32))


def _unitary(rng, d):
    q, r = np.linalg.qr(rng.standard_normal((d, d))
                        + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _rel(got, want):
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(np.asarray(g) - w)))
               for g, w in zip(got, want)) / scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _exact(rng, shape, top, scale):
    """bf16-exact float32 values: integers in [-top, top] times scale (sums
    of two such state values stay bf16-exact for top <= 64)."""
    return _t(rng.integers(-top, top + 1, shape) * scale)


# ---------------------------------------------------------------- kernels
def test_mat_default_plain_matches_one_pass():
    """Kernels 3'/5's "default" mat step (schoolbook) against the jnp
    one-pass emulation of each real product."""
    rng = np.random.default_rng(1)
    re, im = (rng.standard_normal((64, 256)).astype(np.float32) / 16
              for _ in range(2))
    u = _unitary(rng, 256)
    a, b = u.real.T.astype(np.float32), u.imag.T.astype(np.float32)
    got = KB.mat_default_plain(_t(re), _t(im), _t(a), _t(b))
    want = (one_pass(re, a) - one_pass(im, b),
            one_pass(re, b) + one_pass(im, a))
    assert _rel(got, want) <= ONE_PASS_REL


@pytest.mark.parametrize("row_bits", [(), (1,), (0, 3)])
def test_mm_step_default_plain_matches_one_pass(row_bits):
    """mxu's "default" mm step (Karatsuba through the row map, D = 128 <<
    kh) against the jnp emulation between the JAX package's own row
    shuffles: t1 = (re + im).m1, t2 = re.m2, t3 = im.m3, one pass each."""
    rng = np.random.default_rng(2 + len(row_bits))
    D, R = 128 << len(row_bits), 32
    v = (rng.standard_normal((2, R, 128)) / 64).astype(np.float32)
    u = _unitary(rng, D)
    m32 = np.stack([u.real.T, (u.imag - u.real).T,
                    (u.real + u.imag).T]).astype(np.float32)
    w16 = KW.split_mm_tables(torch.from_numpy(m32))
    got = KW.mm_step_default_plain(_t(v[0]), _t(v[1]), w16, row_bits)
    fwd, bwd = JW.row_shuffles(row_bits, R)
    xr, xi = (np.asarray(fwd(jnp.asarray(x))) for x in v)
    t1 = one_pass(xr + xi, m32[0])
    t2, t3 = one_pass(xr, m32[1]), one_pass(xi, m32[2])
    want = tuple(np.asarray(bwd(jnp.asarray(t))) for t in (t1 - t3, t1 + t2))
    assert _rel(got, want) <= ONE_PASS_REL
    out = (torch.empty(R, 128), torch.empty(R, 128))
    assert KW.mm_step_default(_t(v[0]), _t(v[1]), w16, row_bits,
                              out=out) is out
    assert all(torch.equal(o, g) for o, g in zip(out, got))


def test_chain_default_plain_matches_one_pass():
    """Kernel 7's "default" chain against the jnp emulation of
    get_kh0_kernel's "default" step (the combinations formed in float64 and
    rounded to float32, as the wide engine forms them), product by product
    on the same input: along a chain an ulp of difference moves a value's
    bf16 rounding in the next product (2^-9 of it), so a chain is held
    through its products one at a time, and the whole chain equals them in
    turn bit for bit."""
    rng = np.random.default_rng(5)
    re, im = (rng.standard_normal((16, 128)).astype(np.float32) / 32
              for _ in range(2))
    us = [_unitary(rng, 128) for _ in range(3)]
    tables = torch.from_numpy(np.stack([np.stack([u.real, u.imag])
                                        for u in us]).astype(np.float32))
    r, i = re, im
    for j, t in enumerate(tables.double().numpy()):
        got = KW.kh0_chain_plain(_t(r), _t(i), tables[j : j + 1], "default")
        mr, mi = t
        m1, m2, m3 = (x.T.astype(np.float32) for x in (mr, mi - mr, mr + mi))
        t1 = one_pass(r + i, m1)
        t2, t3 = one_pass(r, m2), one_pass(i, m3)
        r, i = t1 - t3, t1 + t2
        assert _rel(got, (r, i)) <= ONE_PASS_REL
    whole = KW.kh0_chain_plain(_t(re), _t(im), tables, "default")
    x = (_t(re), _t(im))
    for j in range(len(tables)):
        x = KW.kh0_chain_plain(*x, tables[j : j + 1], "default")
    assert all(torch.equal(a, b) for a, b in zip(whole, x))
    out = (_t(re), _t(im))
    assert KW.kh0_chain(*out, tables, "default", out=out) is out
    assert all(torch.equal(o, g) for o, g in zip(out, whole))


def test_default_equals_high_on_bf16_exact_operands():
    """On bf16-exact state and tables the "high" rung's lo parts are zero,
    so each of the four "default" plain versions (flat mat step, in-place
    mat step, chain, mm step) equals its "high" one bit for bit."""
    rng = np.random.default_rng(7)
    x = [_exact(rng, (32, 256), 64, 2.0 ** -7) for _ in range(2)]
    a, b = (_exact(rng, (256, 256), 16, 2.0 ** -6) for _ in range(2))
    assert all(torch.equal(d, h) for d, h in zip(
        KB.mat_default_plain(*x, a, b), KB.mat_high_plain(*x, a, b)))

    cap = TPF.CAP_STEPS
    row = [1, 0, 0, 0] + [0] * cap + [0] + [0] * (cap - 1)   # one mat step
    tabs = (a[None], b[None], torch.zeros(1, 256, dtype=torch.int32))
    halves = {rung: KS.run_split_block(
        row, tuple(h.clone() for h in (*KS.split_halves(x[0]),
                                       *KS.split_halves(x[1]))),
        *tabs, 4, cap, precision=rung) for rung in ("high", "default")}
    assert all(torch.equal(d, h)
               for d, h in zip(halves["default"], halves["high"]))

    s = [_exact(rng, (16, 128), 64, 2.0 ** -7) for _ in range(2)]
    # one product: its output is no longer bf16-exact, so a longer chain's
    # later products get lo parts again
    tables = torch.stack([_exact(rng, (128, 128), 16, 2.0 ** -6)
                          for _ in range(2)])[None]
    assert all(torch.equal(d, h) for d, h in zip(
        KW.kh0_chain_plain(*s, tables, "default"),
        KW.kh0_chain_plain(*s, tables, "high")))

    m32 = torch.stack([_exact(rng, (256, 256), 16, 2.0 ** -6)
                       for _ in range(3)])
    w16 = KW.split_mm_tables(m32)
    assert all(torch.equal(d, h) for d, h in zip(
        KW.mm_step_default_plain(*s, w16, (2,)),
        KW.mm_step_high_plain(*s, w16, (2,))))


def test_default_launch_kinds_and_rungs():
    """The rung list, and a launch count of its own for every "default"
    kernel (chip_smoke.py checks each per run)."""
    assert KB.RUNGS == ("highest", "high", "default")
    assert "mat_default" in KB.LAUNCH_KINDS and "mat_default" in KS.LAUNCH_KINDS
    KW.reset_launches()
    assert KW.kh0_chain.launches["default"] == 0
    assert KW.mm_step_default.launches == 0
    assert T.config.resolve_precision("auto", 30) != "default"
    with pytest.raises(ValueError, match="rungs"):
        KB.run_block_plain([0, 0, 0, 0], torch.zeros(4, 256),
                           torch.zeros(4, 256), None, None, None, 2, 8,
                           precision="bogus")


# ------------------------------------------------------------ whole runs
def _err(got, ref):
    return float(np.max(np.abs(np.asarray(got) - ref)))


@pytest.mark.parametrize("engine", ["prefetch", "prefetch_inplace", "mxu"])
def test_simulator_default_rung(engine):
    """``Simulator(precision="default")`` on the CPU: the error against the
    f64 reference and against the JAX package's "default" run (fp32 on the
    CPU) lies above RUNG_FLOOR and within the rung's bar."""
    n = 10 if engine == "mxu" else 12
    kw = dict(strategy="mxu") if engine == "mxu" else dict(
        strategy="prefetch", prefetch_inplace=engine == "prefetch_inplace")
    c = T.models.grover_like(n, 600, seed=41)
    ref = simulate_reference(c)
    got = T.Simulator(T.SimulatorConfig(precision="default", **kw),
                      device="cpu").run(c)
    jgot = np.asarray(JS.Simulator(JConfig(
        strategy=kw["strategy"], precision="default")).run(
            JM.grover_like(n, 600, seed=41)))
    bar = RUNG_BAR if engine != "mxu" else KARATSUBA_BAR * max(
        1.0, float(np.max(np.abs(ref))) / BAR_PEAK)
    for want in (ref, jgot):
        assert RUNG_FLOOR < _err(got, want) <= bar, (_err(got, want), bar)


def test_wide_program_default_runs_chains_and_mm_steps():
    """mxu's "default" program on a circuit of kh = 0 runs and mm steps
    (the chain and the mm step both at the rung): the step list is the
    "high" program's, and the amplitudes are the plain versions' one
    pass, within the Karatsuba bar of the "highest" program."""
    n = 10
    c = T.Circuit(n)      # tests/test_torch_wide.py mixed(): low-heavy
    for i, g in enumerate(T.models.grover_like(7, 260, 41).gates):
        c.gates.append(g)
        if i % 40 == 39:
            c.cx(7, 8).cx(8, 9).h(7)
    ops = TS._fuse_pipeline(c, 7, max_high=2, window=8)
    progs = {rung: TW.WideProgram(ops, n, precision=rung, device="cpu")
             for rung in ("highest", "high", "default")}
    steps = [[st for seg in p.segments for st in seg.steps]
             for p in progs.values()]
    assert steps[0] == steps[1] == steps[2]
    assert progs["default"].num_kh0_runs > 0
    assert any(st[0] == "mm" for st in steps[2])
    start = TA.initial_state_parts(n, device="cpu")
    out = {r: p(*(x.clone() for x in start)) for r, p in progs.items()}
    e = max(float((d - h).abs().max())
            for d, h in zip(out["default"], out["highest"]))
    assert RUNG_FLOOR < e <= KARATSUBA_BAR


def test_only_the_sharded_engines_are_left_to_port():
    """Every NotImplementedError the port raises names ROADMAP queue A's
    "parallel/ on torch.distributed" (directly or through the checkpoint
    module's ``_SHARDED`` message): the "default" rung and complex128 no
    longer raise one."""
    import ast
    import os

    port = os.path.dirname(T.__file__)
    raises = []
    for root, _, names in os.walk(port):
        for f in names:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                for node in ast.walk(ast.parse(open(path).read())):
                    if isinstance(node, ast.Raise) and node.exc is not None \
                            and "NotImplementedError" in ast.unparse(node.exc):
                        raises.append((os.path.relpath(path, port),
                                       ast.unparse(node.exc)))
    assert raises
    stale = [r for r in raises if "parallel/ on torch.distributed" not in r[1]
             and "_SHARDED" not in r[1]]
    assert not stale, stale
