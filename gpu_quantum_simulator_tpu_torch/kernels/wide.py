"""Lane-layout kernel wrappers: chains of 128 x 128 complex right-products.

One CUDA kernel (``csrc/wide_chain.cu``) replaces two TPU kernels of the
JAX package:

* ``engine/wide.py`` ``get_kh0_kernel`` (kernel 7): a run of up to
  ``KH0_BATCH`` consecutive kh = 0 blocks applied while each row tile is
  resident, at the "highest", "high" or "default" rung — ``kh0_chain``;
* ``ops/pallas_kernels.py`` ``apply_block128`` (kernel 9): one such
  product at "highest", the ``pallas`` engine's only matrix step —
  ``apply_block128``.

The state is the (R, 128) float32 pair with the low 7 qubits on the
columns; each product is ``x <- x @ M^T`` (complex).  A chain's tables are
(L, 2, 128, 128) float32 ``[M_re, M_im]``, each stored as M itself ([n][k],
the output index first).  The complex form is the JAX package's
Karatsuba at every rung, in the kernel and in the plain versions alike:
``t1 = (x_re + x_im) @ m1``, ``t2 = x_re @ m2``, ``t3 = x_im @ m3`` with
``m1 = M_re^T``, ``m2 = (M_im - M_re)^T``, ``m3 = (M_re + M_im)^T``, then
``re = t1 - t3``, ``im = t1 + t2``.  At "highest" the three products are
IEEE fp32 and the kernel forms the combinations from the tables as it
stages them.  At "high" each real product is the 3-pass bf16 split
``xh.mh + xl.mh + xh.ml``, the mm step's arithmetic (``karatsuba_high``),
on the combinations formed in float64 and split once per program into the
mm step's D = 128 table image (``kh0_high_tables``), so that a chain of
one product is the D = 128 mm step.  At "default" each real product is the
one bf16 pass ``xh.mh`` (``karatsuba_default``; a kernel body of its own,
on the hi-only image ``split_mm_tables_hi``, as the "default" mm step).

A second kernel (``csrc/mm_high.cu``) is the mxu engine's mm step at the
"high" rung, ``mm_step_high``: the JAX package's Karatsuba product
(``engine/wide.py`` ``_apply_wide_karatsuba``, three XLA dots at
``Precision.HIGH`` between row shuffles) of a block on the lane qubits
and kh <= 2 row bits, D = 128 << kh, on the unshuffled (R, 128) pair: the
kernel reads and writes the state through the block's row map (the map
``row_shuffles`` copies out; no copy is made) into a second pair.  Each
real product is the 3-pass bf16 split on Hopper ``wgmma``, its hi.hi
partials of eight terms summed in fp32 on the CUDA cores; the tables are
split once per program into the kernel's shared-memory image
(``split_mm_tables``; ``mm_tables_f32`` reads them back).  The JAX package
computes it outside any Pallas kernel; it is hand-written here because
cuBLAS's bf16 GEMMs keep their fp32 sums in the tensor core, whose
truncating adds shrink the norm.  At the "default" rung the same kernel's
"default" instantiation, ``mm_step_default``, computes the one bf16 pass
``xh.mh`` of each real product (``karatsuba_default``) with the "high"
arm's hi.hi sums, on a k-loop of its own that keeps wgmma groups queued
while the partials are added, from the hi parts alone
(``split_mm_tables_hi``).

For a CUDA state the wrappers launch the kernel; for a CPU state they run
the plain torch version; any other device raises.  ``kh0_chain.launches``
counts launches by rung, ``apply_block128.launches``,
``mm_step_high.launches`` and ``mm_step_default.launches`` their own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import telemetry
from . import build
from .block import RUNGS, _check_rung, bf16_split, ieee_fp32

LANES = 128
MM_WIDTHS = (128, 256, 512)     # the mm step's D = 128 << kh, kh <= 2
MM_BN = 32                      # output columns a CTA of csrc/mm_high.cu

Pair = Tuple[torch.Tensor, torch.Tensor]


def kh0_high_tables(tables: torch.Tensor,
                    precision: str = "high") -> torch.Tensor:
    """(L, 2, 128, 128) float32 [M_re, M_im] -> the chain's operands at the
    bf16 rung ``precision``: the Karatsuba combinations m1 = M_re^T, m2 =
    (M_im - M_re)^T, m3 = (M_re + M_im)^T formed in float64, rounded to
    float32 and split into the image the D = 128 mm step reads at that rung
    (``rung_mm_tables``): (L, 6 * 128^2) bfloat16 at "high", (L, 3 * 128^2)
    at "default".  The wide engine forms them from the blocks' float64
    matrices instead (``engine/wide.py`` ``_karatsuba``)."""
    t = tables.double()
    mr, mi = t[:, 0], t[:, 1]
    combos = torch.stack([mr, mi - mr, mr + mi], dim=1).transpose(-1, -2)
    return rung_mm_tables(combos.float().contiguous(), precision)


def _karatsuba_f32(re, im, m_re, m_im):
    with ieee_fp32():
        t1 = (re + im) @ m_re.T
        t2 = re @ (m_im - m_re).T
        t3 = im @ (m_re + m_im).T
        return t1 - t3, t1 + t2


def kh0_chain_plain(re: torch.Tensor, im: torch.Tensor,
                    tables: torch.Tensor, precision: str = "highest",
                    w16: Optional[torch.Tensor] = None) -> Pair:
    """The chain in plain torch, on any device: ``x <- x @ M_j^T`` for each
    table j in order, in the kernel's arithmetic, Karatsuba at every rung:
    three IEEE fp32 products at "highest"; at "high" (``karatsuba_high``)
    and "default" (``karatsuba_default``) on the tables read back from
    ``w16`` (``kh0_high_tables(tables, precision)`` when None), each
    product the D = 128 mm step's plain version.  At "default" ``w16`` may
    be either image (the hi parts are the same words); "high" needs the
    full one."""
    _check_rung(precision)
    if precision in KARATSUBA:
        if w16 is None:
            w16 = kh0_high_tables(tables, precision)
        if precision == "high" and _mm_layout(w16) != (LANES, 6):
            raise ValueError(f"chain: the 'high' rung reads the (L, "
                             f"{6 * LANES * LANES}) split_mm_tables image, "
                             f"got {tuple(w16.shape)}")
        for j in range(w16.shape[0]):
            re, im = KARATSUBA[precision](re, im, mm_tables_f32(w16[j]))
        return re, im
    for j in range(tables.shape[0]):
        re, im = _karatsuba_f32(re, im, tables[j, 0], tables[j, 1])
    return re, im


def apply_block128_plain(re: torch.Tensor, im: torch.Tensor,
                         m_re: torch.Tensor, m_im: torch.Tensor) -> Pair:
    """One product ``x @ M^T``: Karatsuba in IEEE fp32, on any device."""
    return _karatsuba_f32(re, im, m_re, m_im)


def _to_out(res: Pair, out: Optional[Pair]) -> Pair:
    if out is None:
        return res
    out[0].copy_(res[0])
    out[1].copy_(res[1])
    return out


def _check_cuda(tensors, dtypes, what: str) -> None:
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous {dt}, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned "
                             f"(the kernel copies 16-byte pieces)")


def _state_out(re, im, out, what: str) -> Pair:
    rows = re.shape[0]
    if re.dim() != 2 or re.shape != (rows, LANES) or im.shape != re.shape:
        raise ValueError(f"{what}: state must be (R, {LANES}), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    if out[0].shape != re.shape or out[1].shape != re.shape:
        raise ValueError(f"{what}: out must match the state's shape")
    return out


@telemetry.counted
def kh0_chain(re: torch.Tensor, im: torch.Tensor, tables: torch.Tensor,
              precision: str = "highest", out: Optional[Pair] = None,
              w16: Optional[torch.Tensor] = None) -> Pair:
    """Apply the chain of ``tables`` (L, 2, 128, 128) to the (R, 128) pair.

    The result lands in ``out`` (allocated when None; it may be the input
    pair itself: each row tile is read whole before it is written).
    ``w16``: the "high" and "default" rungs' operands, the image the
    kernel reads at the rung (``kh0_high_tables(tables, precision)`` when
    None): (L, 6 * 128^2) bfloat16 at "high", (L, 3 * 128^2) at "default";
    the other rung's image raises ValueError, on every device.
    """
    _check_rung(precision)
    if precision in KARATSUBA:
        if w16 is None:
            w16 = kh0_high_tables(tables, precision)
        words = (3 if precision == "default" else 6) * LANES * LANES
        if tuple(w16.shape) != (tables.shape[0], words) \
                or w16.dtype != torch.bfloat16:
            raise ValueError(f"chain kernel: w16 must be ({tables.shape[0]}, "
                             f"{words}) bfloat16 at {precision!r} (the "
                             f"rung's image), got {tuple(w16.shape)} "
                             f"{w16.dtype}")
    if re.device.type == "cpu":
        return _to_out(kh0_chain_plain(re, im, tables, precision, w16), out)
    if not re.is_cuda:
        raise ValueError(f"chain kernel: unsupported device {re.device}")
    out = _state_out(re, im, out, "chain kernel")
    nmats = tables.shape[0]
    if tables.dim() != 4 or tables.shape[1:] != (2, LANES, LANES) \
            or nmats < 1:
        raise ValueError(f"chain kernel: tables must be (L >= 1, 2, "
                         f"{LANES}, {LANES}), got {tuple(tables.shape)}")
    f32 = torch.float32
    lib = build.load()
    stream = torch.cuda.current_stream(re.device).cuda_stream
    if precision in KARATSUBA:
        _check_cuda([re, im, *out, w16], [f32] * 4 + [torch.bfloat16],
                    "chain kernel")
        rc = lib.qsim_wide_chain_high(
            re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), w16.data_ptr(), nmats, re.shape[0],
            int(precision == "high"), stream)
    else:
        _check_cuda([re, im, *out, tables], [f32] * 5, "chain kernel")
        rc = lib.qsim_wide_chain(
            re.data_ptr(), im.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), tables[:, 0].data_ptr(),
            tables[:, 1].data_ptr(), 2 * LANES * LANES, nmats, re.shape[0],
            stream)
    build.check(lib, rc, f"chain kernel ({precision}, {nmats} products)")
    kh0_chain.launches[precision] += 1
    return out


TPU_TILE_ROWS = 512      # the JAX op's default row tile (VMEM blocking)


def check_tpu_keywords(interpret, rows: int = 0,
                       tile_rows: Optional[int] = None) -> None:
    """Check the JAX ops' TPU-only keywords as the JAX package does, so that
    a call written for its signature means the same here: ``interpret`` a
    bool, ``tile_rows`` (when given) a positive int whose
    ``min(tile_rows, R)`` divides the ``rows``.  Neither changes what the
    card runs: the row tile is the CUDA kernel's own, and Pallas's
    interpret mode is the CPU's plain torch version, which a CPU tensor
    selects."""
    if tile_rows is not None and (
            isinstance(tile_rows, bool) or not isinstance(tile_rows, int)
            or tile_rows < 1 or rows % min(tile_rows, rows)):
        raise ValueError(f"tile_rows must be a positive int whose "
                         f"min(tile_rows, R) divides R = {rows}, got "
                         f"{tile_rows!r}")
    if not isinstance(interpret, bool):
        raise ValueError(f"interpret must be a bool, got {interpret!r}")


@telemetry.counted
def apply_block128(s_re: torch.Tensor, s_im: torch.Tensor,
                   m_re: torch.Tensor, m_im: torch.Tensor, *,
                   tile_rows: int = TPU_TILE_ROWS, interpret: bool = False,
                   out: Optional[Pair] = None) -> Pair:
    """``(s_re + i s_im) @ (m_re + i m_im)^T`` on the (R, 128) pair, IEEE
    fp32, with the JAX op's signature.

    ``tile_rows`` and ``interpret`` are checked (``check_tpu_keywords``)
    and otherwise ignored: they pick the TPU kernel's VMEM tile and Pallas's
    interpreter, and the card runs its own tiling while a CPU state runs
    the plain version.  The result lands in ``out`` (allocated when None;
    it may be the input pair)."""
    re, im = s_re, s_im
    check_tpu_keywords(interpret, re.shape[0], tile_rows)
    if re.device.type == "cpu":
        return _to_out(apply_block128_plain(re, im, m_re, m_im), out)
    if not re.is_cuda:
        raise ValueError(f"block128 kernel: unsupported device {re.device}")
    out = _state_out(re, im, out, "block128 kernel")
    if m_re.shape != (LANES, LANES) or m_im.shape != m_re.shape:
        raise ValueError(f"block128 kernel: matrices must be ({LANES}, "
                         f"{LANES})")
    _check_cuda([re, im, *out, m_re, m_im], [torch.float32] * 6,
                "block128 kernel")
    lib = build.load()
    rc = lib.qsim_wide_chain(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        m_re.data_ptr(), m_im.data_ptr(), 0, 1, re.shape[0],
        torch.cuda.current_stream(re.device).cuda_stream)
    build.check(lib, rc, "block128 kernel")
    apply_block128.launches += 1
    return out


def split_mm_tables(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, D, D) float32 Karatsuba tables [m1, m2, m3], each [k][n]
    (the step is ``x @ m``) -> (..., 6 D^2) bfloat16: the six parts [m1_hi,
    m1_lo, m2_hi, m2_lo, m3_hi, m3_lo] (hi = the table rounded to bf16, lo
    = the bf16 of the residual) in the shared-memory image of
    ``csrc/mm_high.cu``.  Per 32-column block and k-chunk of 16, the six
    parts, each 16-byte core matrices [kc 2][n 32][8] (the K-major
    unswizzled wgmma B operand), position 8 kc + 2 a + b of the chunk
    holding k 4 a + 2 kc + b.  Done once per program."""
    lead, D = m.shape[:-3], m.shape[-1]
    L = len(lead)
    hi, lo = bf16_split(m)
    # k = 16 c + 4 a + 2 kc + b, n = 32 cb + nn
    t = torch.stack([hi, lo], dim=-3).reshape(
        *lead, 3, 2, D // 16, 4, 2, 2, D // MM_BN, MM_BN)
    # (P, HL, c, a, kc, b, cb, nn) -> (cb, c, P, HL, kc, nn, a, b)
    t = t.permute(*range(L), *(L + d for d in (6, 2, 0, 1, 4, 7, 3, 5)))
    return t.to(torch.bfloat16).reshape(*lead, 6 * D * D)


def split_mm_tables_hi(m: torch.Tensor) -> torch.Tensor:
    """``split_mm_tables`` for the "default" mm step and chain, which read
    the hi parts alone: (..., 3 D^2) bfloat16, per 32-column block and
    k-chunk of 16 the three parts [m1_hi, m2_hi, m3_hi], each word for word
    the same part of ``split_mm_tables``' image (half its bytes: 96 KB of
    shared memory a column block at D = 512 instead of 192).  Done once
    per program."""
    lead, D = m.shape[:-3], m.shape[-1]
    L = len(lead)
    t = m.to(torch.bfloat16).reshape(*lead, 3, D // 16, 4, 2, 2,
                                     D // MM_BN, MM_BN)
    # (P, c, a, kc, b, cb, nn) -> (cb, c, P, kc, nn, a, b)
    t = t.permute(*range(L), *(L + d for d in (5, 1, 0, 3, 6, 2, 4)))
    return t.reshape(*lead, 3 * D * D)


def rung_mm_tables(m: torch.Tensor, precision: str) -> torch.Tensor:
    """The image the rung's mm kernel and chain read: ``split_mm_tables``
    at "high", ``split_mm_tables_hi`` at "default"."""
    return (split_mm_tables_hi if precision == "default"
            else split_mm_tables)(m)


def _mm_layout(w16: torch.Tensor) -> Tuple[int, int]:
    """(D, parts) of a ``split_mm_tables`` (6 parts) or
    ``split_mm_tables_hi`` (3) image."""
    for parts in (6, 3):
        D = int(round((w16.shape[-1] / parts) ** 0.5)) if w16.dim() else 0
        if D in MM_WIDTHS and w16.shape[-1] == parts * D * D:
            return D, parts
    raise ValueError(f"mm step: tables must be (..., 6 D^2) or (..., 3 D^2) "
                     f"with D in {MM_WIDTHS}, got {tuple(w16.shape)}")


def mm_hi_image(w16: torch.Tensor) -> torch.Tensor:
    """The hi parts of a ``split_mm_tables`` image as a new
    ``split_mm_tables_hi`` image (of the same tables)."""
    lead, D = w16.shape[:-1], _mm_layout(w16)[0]
    t = w16.reshape(*lead, D // MM_BN, D // 16, 3, 2, -1)[..., 0, :]
    return t.reshape(*lead, 3 * D * D).contiguous()


def mm_tables_f32(w16: torch.Tensor) -> list:
    """The six float32 [k][n] tables of a ``split_mm_tables`` image:
    [m1_hi, m1_lo, m2_hi, m2_lo, m3_hi, m3_lo], bf16-exact values.  Of a
    ``split_mm_tables_hi`` image, which holds no lo parts, the lo tables
    are zeros."""
    lead = w16.shape[:-1]
    D, parts = _mm_layout(w16)
    hl = parts // 3
    L = len(lead)
    t = w16.float().reshape(*lead, D // MM_BN, D // 16, 3, hl, 2, MM_BN, 4,
                            2)
    # (cb, c, P, HL, kc, nn, a, b) -> (P, HL, c, a, kc, b, cb, nn)
    t = t.permute(*range(L), *(L + d for d in (2, 3, 1, 6, 4, 7, 0, 5)))
    t = t.reshape(*lead, parts, D, D)
    tabs = [t[..., j, :, :].contiguous() for j in range(parts)]
    if hl == 1:
        zero = torch.zeros_like(tabs[0])
        tabs = [tabs[0], zero, tabs[1], zero, tabs[2], zero]
    return tabs


def karatsuba_high(xr: torch.Tensor, xi: torch.Tensor, tabs) -> Pair:
    """t1 = (xr + xi).m1, t2 = xr.m2, t3 = xi.m3, each real product
    ``xh @ mh + xl @ mh + xh @ ml`` of bf16-exact float32 values summed in
    IEEE fp32; returns (t1 - t3, t1 + t2).  ``tabs``: ``mm_tables_f32``."""
    def dot(x, c):
        xh, xl = bf16_split(x)
        return xh @ tabs[2 * c] + xl @ tabs[2 * c] + xh @ tabs[2 * c + 1]

    with ieee_fp32():
        t1 = dot(xr + xi, 0)
        t2 = dot(xr, 1)
        t3 = dot(xi, 2)
        return t1 - t3, t1 + t2


def karatsuba_default(xr: torch.Tensor, xi: torch.Tensor, tabs) -> Pair:
    """``karatsuba_high`` with the hi.hi term alone: each real product the
    one bf16 pass ``xh @ mh`` (x and the table rounded to bf16, the
    products summed in IEEE fp32), as the JAX package's dot at
    ``Precision.DEFAULT`` on the TPU.  ``tabs``: ``mm_tables_f32`` (the lo
    tables are not read)."""
    def dot(x, c):
        return bf16_split(x)[0] @ tabs[2 * c]

    with ieee_fp32():
        t1 = dot(xr + xi, 0)
        t2 = dot(xr, 1)
        t3 = dot(xi, 2)
        return t1 - t3, t1 + t2


# the bf16 rungs' Karatsuba products, as the kernels compute them
KARATSUBA = {"high": karatsuba_high, "default": karatsuba_default}


def row_shuffles(row_bits, R):
    """(fwd, bwd) moving the given row bits adjacent to the lane dim.

    Rank <= 6 views.  fwd flattens to (-1, D); bwd restores (R, LANES).
    D-index bit 7+j <-> row_bits[j] (ascending), matching _op_spec's
    superset ordering.  (The JAX package's, engine/wide.py; the mm kernel
    reads the same map without copying.)
    """
    kh = len(row_bits)
    if kh == 0:
        return (lambda x: x.reshape(-1, LANES)), (lambda t: t.reshape(R, LANES))
    if kh == 1:
        b1 = row_bits[0]
        g, st = R >> (b1 + 1), 1 << b1

        def fwd(x):
            t = x.reshape(g, 2, st, LANES).transpose(1, 2)
            return t.reshape(-1, 2 * LANES)

        def bwd(t):
            t = t.reshape(g, st, 2, LANES).transpose(1, 2)
            return t.reshape(R, LANES)

        return fwd, bwd
    b1, b2 = row_bits
    g = R >> (b2 + 1)
    m = 1 << (b2 - b1 - 1)
    st = 1 << b1

    def fwd2(x):
        t = x.reshape(g, 2, m, 2, st, LANES).permute(0, 2, 4, 1, 3, 5)
        return t.reshape(-1, 4 * LANES)

    def bwd2(t):
        t = t.reshape(g, m, st, 2, 2, LANES).permute(0, 3, 1, 4, 2, 5)
        return t.reshape(R, LANES)

    return fwd2, bwd2


def _mm_step_plain(re, im, w16, row_bits, precision: str) -> Pair:
    fwd, bwd = row_shuffles(tuple(row_bits), re.shape[0])
    t1, t2 = KARATSUBA[precision](fwd(re), fwd(im), mm_tables_f32(w16))
    return bwd(t1), bwd(t2)


def mm_step_high_plain(re: torch.Tensor, im: torch.Tensor, w16: torch.Tensor,
                       row_bits: Sequence[int]) -> Pair:
    """The "high" mm step in plain torch, on any device: the (R, 128) pair
    shuffled by ``row_shuffles`` (fwd), ``karatsuba_high`` on the tables
    read back from the ``split_mm_tables`` image ``w16``, shuffled back."""
    return _mm_step_plain(re, im, w16, row_bits, "high")


def mm_step_default_plain(re: torch.Tensor, im: torch.Tensor,
                          w16: torch.Tensor,
                          row_bits: Sequence[int]) -> Pair:
    """The "default" mm step in plain torch: ``mm_step_high_plain`` with
    ``karatsuba_default`` (the hi parts of ``w16``)."""
    return _mm_step_plain(re, im, w16, row_bits, "default")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _mm_step(re, im, w16, row_bits, out, precision: str) -> Pair:
    """``mm_step_high`` (precision "high") or ``mm_step_default``."""
    row_bits = tuple(int(b) for b in row_bits)
    R = re.shape[0] if re.dim() == 2 else -1
    if R < 1 or re.shape != (R, LANES) or im.shape != re.shape:
        raise ValueError(f"mm step: state must be (R, {LANES}), got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    D = LANES << len(row_bits)
    if len(row_bits) > 2 or list(row_bits) != sorted(set(row_bits)) \
            or any(b < 0 or (2 << b) > R for b in row_bits) or R & (R - 1):
        raise ValueError(f"mm step: row_bits must be at most two ascending "
                         f"bits of the {R} rows (a power of two), got "
                         f"{row_bits}")
    hi = precision == "default"
    sizes = [((3 if hi else 6) * D * D,)]
    if hi and re.device.type == "cpu":
        sizes.append((6 * D * D,))         # the plain version reads either
    if tuple(w16.shape) not in sizes or w16.dtype != torch.bfloat16:
        raise ValueError(f"mm step: tables must be "
                         f"{' or '.join(map(str, sizes))} bfloat16 for D = "
                         f"{D} at {precision!r}, got {tuple(w16.shape)} "
                         f"{w16.dtype}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError(f"mm step: state must be float32, got {re.dtype} "
                         f"and {im.dtype}")
    if out is not None:
        if out[0].shape != re.shape or out[1].shape != re.shape:
            raise ValueError("mm step: out must match the state's shape")
        if any(_overlaps(o, x) for o in out for x in (re, im)) \
                or _overlaps(*out):
            raise ValueError("mm step: out must not alias the input pair "
                             "or itself (the kernel is not in place)")
    if re.device.type == "cpu":
        return _to_out(_mm_step_plain(re, im, w16, row_bits, precision), out)
    if not re.is_cuda:
        raise ValueError(f"mm step: unsupported device {re.device}")
    if out is None:
        out = (torch.empty_like(re), torch.empty_like(im))
    _check_cuda([re, im, *out, w16], [torch.float32] * 4 + [torch.bfloat16],
                "mm step")
    bits = row_bits + (-1,) * (2 - len(row_bits))
    lib = build.load()
    rc = lib.qsim_mm_step_high(
        re.data_ptr(), im.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        w16.data_ptr(), R, D, *bits, int(precision == "high"),
        torch.cuda.current_stream(re.device).cuda_stream)
    build.check(lib, rc, f"mm step ({precision}, D = {D})")
    MM_STEPS[precision].launches += 1
    return out


@telemetry.counted
def mm_step_high(re: torch.Tensor, im: torch.Tensor, w16: torch.Tensor,
                 row_bits: Sequence[int], out: Optional[Pair] = None) -> Pair:
    """The mxu engine's "high" mm step on the unshuffled (R, 128) pair: the
    block on the lane qubits and the row bits ``row_bits`` (ascending, at
    most two; D = 128 << len(row_bits)), one launch of ``csrc/mm_high.cu``
    for CUDA tensors, which reads and writes the state through the row map,
    and ``mm_step_high_plain`` for CPU tensors.  ``w16``: (6 D^2,) bfloat16,
    ``split_mm_tables`` of the step's tables.  The result lands in ``out``
    (allocated when None), a pair that must not overlap the input."""
    return _mm_step(re, im, w16, row_bits, out, "high")


@telemetry.counted
def mm_step_default(re: torch.Tensor, im: torch.Tensor, w16: torch.Tensor,
                    row_bits: Sequence[int],
                    out: Optional[Pair] = None) -> Pair:
    """``mm_step_high`` at the "default" rung: one launch of the same
    kernel's "default" instantiation (the hi.hi sums alone, on a k-loop of
    its own) for CUDA tensors, ``mm_step_default_plain`` for CPU tensors;
    counted on ``mm_step_default.launches``.  ``w16``: (3 D^2,)
    ``split_mm_tables_hi`` of the step's tables, the image the kernel
    reads; on the CPU the plain version also reads their (6 D^2,)
    ``split_mm_tables``."""
    return _mm_step(re, im, w16, row_bits, out, "default")


MM_STEPS = {"high": mm_step_high, "default": mm_step_default}


def reset_launches() -> None:
    """Set the launch counts of ``kh0_chain``, ``apply_block128``,
    ``mm_step_high`` and ``mm_step_default`` to 0."""
    kh0_chain.launches = dict.fromkeys(RUNGS, 0)
    apply_block128.launches = 0
    mm_step_high.launches = 0
    mm_step_default.launches = 0


reset_launches()
