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


# ------------------------------------------------------- the table images
@pytest.mark.parametrize("lead", [(), (3,)])
def test_hi_mat_image_is_the_hi_parts_of_split_tables(lead):
    """What the "default" mat kernel reads of ``split_tables``' image: per
    64-column block and k-chunk of 16, parts 0 and 2 of [A_hi | A_lo |
    B_hi | B_lo], word for word the bf16 rounding of A and B in the
    kernel's order; per slot when the tables have a leading dimension.
    Parts 1 and 3 are the rounded remainders, which it skips."""
    rng = np.random.default_rng(11)
    a, b = (_t(rng.standard_normal((*lead, 256, 256))) for _ in range(2))
    full = KB.split_tables(a, b)
    assert full.dtype == torch.int32 and full.is_contiguous()
    assert tuple(full.shape) == (*lead, KB.HIGH_SLOT_WORDS)
    parts = full.reshape(*lead, 4, 16, 4, 512).view(torch.bfloat16)
    for j, t in ((0, a), (2, b)):
        order = KB.kernel_order(t)
        hi = order.to(torch.bfloat16)
        assert torch.equal(parts[..., j, :], hi)
        assert torch.equal(parts[..., j + 1, :],
                           (order - hi.float()).to(torch.bfloat16))


@pytest.mark.parametrize("site", ["flat", "inplace"])
def test_mat_launch_sites_take_the_rungs_image(site):
    """Both launch sites of the bf16 mat step take ``split_tables``' image
    at both rungs (the "default" kernel reads its hi parts) and refuse,
    before choosing a device, an image of another size: half of it, which
    would be the hi parts alone, included."""
    rng = np.random.default_rng(19)
    cap = TPF.CAP_STEPS
    row = [1, 0, 0, 0] + [0] * cap + [0] + [0] * (cap - 1)
    a, b = (_t(rng.standard_normal((1, 256, 256)) / 16) for _ in range(2))
    mono = torch.zeros(1, 256, dtype=torch.int32)
    x = [_t(rng.standard_normal((16, 256)) / 16) for _ in range(2)]

    def run(rung, tables):
        if site == "flat":
            return KB.run_block(row, *x, a, b, mono, 4, cap,
                                precision=rung, high_tables=tables)
        return KS.run_split_block(row, (*KS.split_halves(x[0]),
                                        *KS.split_halves(x[1])), a, b,
                                  mono, 4, cap, precision=rung,
                                  high_tables=tables)

    full = KB.split_tables(a, b)
    for rung in ("default", "high"):
        run(rung, full)
        with pytest.raises(ValueError, match="high_tables"):
            run(rung, full[:, : KB.HIGH_SLOT_WORDS // 2].contiguous())


@pytest.mark.parametrize("D", [128, 256, 512])
def test_hi_mm_image_is_the_hi_parts_of_split_mm_tables(D):
    """The "default" mm kernel's image (``split_mm_tables_hi``) is, per
    32-column block and k-chunk of 16, the m1_hi, m2_hi, m3_hi parts of
    ``split_mm_tables``' six word for word; ``mm_hi_image`` takes them out
    of a full image, and ``mm_tables_f32`` reads a hi image back as the
    full image's hi tables with zero lo tables."""
    rng = np.random.default_rng(D)
    m = _t(rng.standard_normal((3, D, D)))
    full = KW.split_mm_tables(m)
    hi = KW.split_mm_tables_hi(m)
    assert hi.dtype == torch.bfloat16 and tuple(hi.shape) == (3 * D * D,)
    part = 2 * KW.MM_BN * 16 // 2          # bf16 values of a part
    blocks = (D // KW.MM_BN, D // 16)
    assert torch.equal(hi.view(*blocks, 3, part),
                       full.view(*blocks, 3, 2, part)[..., 0, :])
    assert torch.equal(KW.mm_hi_image(full), hi)
    assert torch.equal(KW.rung_mm_tables(m, "default"), hi)
    assert torch.equal(KW.rung_mm_tables(m, "high"), full)
    back, want = KW.mm_tables_f32(hi), KW.mm_tables_f32(full)
    for j in range(6):
        assert torch.equal(back[j], want[j] if j % 2 == 0
                           else torch.zeros(D, D))
    two = torch.stack([m, m.flip(-1)])
    assert torch.equal(KW.split_mm_tables_hi(two)[1],
                       KW.split_mm_tables_hi(m.flip(-1)))


def test_mm_step_tables_by_rung():
    """On the CPU the "default" mm step's plain version reads the hi
    image or the full one (the same values); "high" takes the full one
    alone."""
    rng = np.random.default_rng(13)
    D, R = 256, 16
    v = [_t(rng.standard_normal((R, 128)) / 16) for _ in range(2)]
    m = _t(rng.standard_normal((3, D, D)) / 16)
    full, hi = KW.split_mm_tables(m), KW.split_mm_tables_hi(m)
    a = KW.mm_step_default(*v, hi, (1,))
    b = KW.mm_step_default(*v, full, (1,))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="mm step: tables"):
        KW.mm_step_high(*v, hi, (1,))


@pytest.mark.parametrize("inplace", [False, True])
def test_prefetch_chains_build_the_rungs_image(monkeypatch, inplace):
    """``DeviceChain`` (flat) and ``SplitChain`` (in place, part by part as
    it runs) split the tables into ``split_tables``' image at both bf16
    rungs, the image the "default" kernel reads as the "high" one does.
    On the CPU the chains split nothing (the plain versions read the
    float32 tables), so the split is switched on here; the plain run then
    checks each image's size, and the amplitudes are those of the chain
    without it."""
    n = 12
    ops = TS._fuse_pipeline(T.models.grover_like(n, 300, 13), 7, max_high=2)
    made = []
    real = TPF.split_tables

    def spy(a, b):
        out = real(a, b)
        made.append(out.shape[-1])
        return out

    want = {}
    for split in (False, True):
        monkeypatch.setattr(TPF, "splits_tables", lambda dev, s=split: s)
        monkeypatch.setattr(TPF, "split_tables", spy)
        for rung in ("high", "default"):
            made.clear()
            prog = TPF.PrefetchProgram(ops, n, precision=rung, device="cpu",
                                       inplace=inplace)
            out = prog.run_parts(*TPF.initial_halves(n, "cpu")) if inplace \
                else prog(*TA.initial_state_parts(n, device="cpu"))
            if not split:
                assert made == []
                want[rung] = out
                continue
            words = KB.HIGH_SLOT_WORDS
            assert made and all(m == words for m in made), made
            if not inplace:
                assert all(part[4].shape[-1] == words
                           for part in prog._chain._parts)
            assert all(torch.equal(x, y) for x, y in zip(out, want[rung]))


def test_wide_program_builds_the_rungs_mm_image():
    """``WideProgram`` holds its mm steps' tables as the hi image at
    "default" (``split_mm_tables_hi``, 3 D^2) and the full image at "high"
    (6 D^2), and so its kh = 0 runs' chain tables: (L, 3 * 128^2) at
    "default", (L, 6 * 128^2) at "high" (each chain arm reads its rung's
    image)."""
    n = 10
    c = T.Circuit(n)
    for i, g in enumerate(T.models.grover_like(7, 260, 41).gates):
        c.gates.append(g)
        if i % 40 == 39:
            c.cx(7, 8).cx(8, 9).h(7)
    ops = TS._fuse_pipeline(c, 7, max_high=2, window=8)
    for rung, parts in (("high", 6), ("default", 3)):
        prog = TW.WideProgram(ops, n, precision=rung, device="cpu")
        mm = [t for seg in prog.segments for t in seg.mm.values()]
        runs = [w for seg in prog.segments for w in seg.runs_w16]
        assert mm and runs
        for t in mm:
            D = int(round((t.shape[-1] / parts) ** 0.5))
            assert t.dtype == torch.bfloat16 and t.shape[-1] == parts * D * D
        assert all(w.dtype == torch.bfloat16 and w.dim() == 2
                   and w.shape[-1] == parts * 128 * 128 for w in runs)


def test_chain_plain_reads_either_default_image():
    """At "default" the chain's plain version reads the hi-only image
    (``kh0_high_tables(tables, "default")``, what the kernel reads) and the
    full one to the same result bit for bit: the hi parts are the same
    words; the hi image is the full image's hi parts."""
    rng = np.random.default_rng(23)
    x = [_t(rng.standard_normal((16, 128)) / 16) for _ in range(2)]
    us = [_unitary(rng, 128) for _ in range(3)]
    tables = _t(np.stack([np.stack([u.real, u.imag]) for u in us]))
    full = KW.kh0_high_tables(tables)
    hi = KW.kh0_high_tables(tables, "default")
    assert full.shape == (3, 6 * 128 * 128) and hi.shape == (3, 3 * 128 * 128)
    assert hi.dtype == torch.bfloat16
    assert torch.equal(hi, KW.mm_hi_image(full))
    got = KW.kh0_chain_plain(*x, tables, "default", w16=hi)
    assert all(torch.equal(a, b) for a, b in zip(
        got, KW.kh0_chain_plain(*x, tables, "default", w16=full)))
    assert all(torch.equal(a, b) for a, b in zip(
        got, KW.kh0_chain_plain(*x, tables, "default")))
    out = KW.kh0_chain(*x, tables, "default", w16=hi)
    assert all(torch.equal(a, b) for a, b in zip(out, got))


@pytest.mark.parametrize("rung", ["high", "default"])
def test_chain_refuses_the_other_rungs_image(rung):
    """``kh0_chain`` takes the image its rung's kernel reads and raises
    ValueError for the other rung's, on every device (here the CPU, before
    the plain version runs); the "high" plain version refuses the hi-only
    image, which lacks its lo parts."""
    rng = np.random.default_rng(29)
    x = [_t(rng.standard_normal((8, 128)) / 16) for _ in range(2)]
    tables = _t(np.stack([np.stack([u.real, u.imag])
                          for u in [_unitary(rng, 128)]]))
    other = KW.kh0_high_tables(
        tables, "high" if rung == "default" else "default")
    KW.reset_launches()
    with pytest.raises(ValueError, match="rung's image"):
        KW.kh0_chain(*x, tables, rung, w16=other)
    with pytest.raises(ValueError, match="rung's image"):
        KW.kh0_chain(*x, tables, rung, w16=KW.kh0_high_tables(tables, rung)
                     .float())
    if rung == "high":
        with pytest.raises(ValueError, match="'high' rung reads"):
            KW.kh0_chain_plain(*x, tables, "high", w16=other)
    mine = KW.kh0_chain(*x, tables, rung,
                        w16=KW.kh0_high_tables(tables, rung))
    assert all(torch.equal(a, b) for a, b in zip(
        mine, KW.kh0_chain_plain(*x, tables, rung)))
    assert KW.kh0_chain.launches == dict.fromkeys(KB.RUNGS, 0)


def test_default_launch_counters_count_launches_alone():
    """The "default" kernels' launch counters (``mat_default`` of both mat
    wrappers, ``mm_step_default.launches``, ``kh0_chain.launches
    ["default"]``) exist beside the "high" ones, and a CPU run, which
    launches nothing, leaves every one of them at 0."""
    KB.reset_launches()
    KS.reset_launches()
    KW.reset_launches()
    rng = np.random.default_rng(17)
    x = [_t(rng.standard_normal((16, 128)) / 16) for _ in range(2)]
    m = _t(rng.standard_normal((3, 256, 256)) / 16)
    KW.mm_step_default(*x, KW.split_mm_tables_hi(m), (2,))
    tables = _t(rng.standard_normal((2, 2, 128, 128)) / 16)
    KW.kh0_chain(*x, tables, "default")
    prog = TPF.PrefetchProgram(
        TS._fuse_pipeline(T.models.grover_like(12, 200, 5), 7, max_high=2),
        12, precision="default", device="cpu", inplace=True)
    prog.run_parts(*TPF.initial_halves(12, "cpu"))
    assert KB.run_block.launches == dict.fromkeys(KB.LAUNCH_KINDS, 0)
    assert KS.run_split_block.launches == dict.fromkeys(KS.LAUNCH_KINDS, 0)
    assert KW.mm_step_default.launches == 0 == KW.mm_step_high.launches
    assert KW.kh0_chain.launches == dict.fromkeys(KB.RUNGS, 0)
    assert "mat_default" in KB.LAUNCH_KINDS and "mat_high" in KB.LAUNCH_KINDS


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
    """The port is whole: no NotImplementedError is raised anywhere in it
    (the sharded engines, the last to be ported, raised the last ones)."""
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
    assert not raises, raises
    assert os.path.isfile(os.path.join(port, "parallel", "sharded.py"))
