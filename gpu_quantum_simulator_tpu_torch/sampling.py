"""Measurement sampling on the state's device — no full-state transfer.

The torch counterpart of ``gpu_quantum_simulator_tpu/sampling.py``.  The
distribution, its CDFs and the inverse-CDF searches run where the state
lies (a CUDA card, or the CPU in the tests); only the sampled indices and
scalars (a few KB) reach the host.  Plain torch ops throughout: the JAX
module has no hand-written kernel either.

Flat states are (2^n,) float32 ``re``/``im`` tensors; split states are the
four (R2, 128) column halves ``(re0, re1, im0, im1)`` of the in-place
prefetch engine (basis index = (row << 8) | column, half h1 holding
columns 128..255).  The halves functions never build a 2^n tensor: they
reduce in row chunks, so their transients stay a few MB whatever n is.
Sharded states (the "sharded" strategy) are two lists of per-shard
tensors, shard s holding the basis indices s * 2^nl .. (s + 1) * 2^nl - 1
on its own device; ``sample_state_device``, ``top_amplitudes_device``,
``norm_device``, ``amplitudes_device`` and ``expectation_z`` take them and
work shard by shard.  Only reductions reach the first shard's device: the
2^(n-8) row masses of the staged sampler (a shard boundary is a row
boundary, since a shard holds at least 2^9 amplitudes) and, up to
``STAGE_SPLIT_MIN`` qubits, the 2^n probabilities of the one-CDF sampler.
Global indices are int64 (shard << nl | local), past 2^31 at n = 31.

Staged sampling keeps float32 CDFs accurate at large n: one f32 cumsum over
2^30 probabilities accumulates ~1e-5 error and biases the tail, so above
``STAGE_SPLIT_MIN`` qubits the state is viewed as (rows, 256); stage 1
samples a group of rows, stage 2 a row within it, stage 3 a column within
that row.  Every cumsum then spans at most ~2^12 terms.

Random draws come from a ``torch.Generator`` on the state's device, seeded
from ``seed``: a run is reproducible from its seed, but its stream is not
``jax.random``'s, so the two packages' samples agree in distribution, not
draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from .parallel.sharded import is_sharded

STAGE_SPLIT_MIN = 20
LANES = 128
DVIEW = 256
CHUNK_ROWS = 1 << 16      # rows reduced at a time by the halves functions
DOT_CHUNK = 1 << 30       # elements of one dot product in norm_device


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _host_indices(idx: torch.Tensor) -> np.ndarray:
    return idx.cpu().numpy().astype(np.int64)


def _pick(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per row of ``cdf`` (S, m): the first index whose cumulative mass
    reaches ``u`` (S, 1), as a count of the entries below it."""
    return torch.clamp((cdf < u).sum(dim=1), max=cdf.shape[1] - 1)


def _sample_direct(p, num_samples, gen):
    cdf = torch.cumsum(p, 0)
    u = torch.rand(num_samples, device=p.device, dtype=cdf.dtype,
                   generator=gen) * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, u, right=True),
                       max=cdf.numel() - 1)


def _staged(pr: torch.Tensor, columns, num_samples: int, gen):
    """Group -> row -> column sampling from the row masses ``pr`` (R,);
    ``columns(row)`` returns the (S, 256) probabilities of the rows drawn."""
    R = pr.numel()
    rb = R.bit_length() - 1
    g_bits = rb // 2
    rows_per = 1 << g_bits
    G = R >> g_bits
    pg = pr.reshape(G, rows_per)
    dev, dt = pr.device, pr.dtype
    gcdf = torch.cumsum(pg.sum(dim=1), 0)
    u1 = torch.rand(num_samples, device=dev, dtype=dt, generator=gen) * gcdf[-1]
    g = torch.clamp(torch.searchsorted(gcdf, u1, right=True), max=G - 1)
    rcdf = torch.cumsum(pg[g], dim=1)                      # (S, rows_per)
    u2 = torch.rand((num_samples, 1), device=dev, dtype=dt,
                    generator=gen) * rcdf[:, -1:]
    row = g * rows_per + _pick(rcdf, u2)
    ccdf = torch.cumsum(columns(row), dim=1)               # (S, 256)
    u3 = torch.rand((num_samples, 1), device=dev, dtype=dt,
                    generator=gen) * ccdf[:, -1:]
    return (row << 8) | _pick(ccdf, u3)


def sample_state_device(re, im, num_qubits: int, num_samples: int,
                        seed: int = 0) -> np.ndarray:
    """Sample basis-state indices from a flat (re, im) state on its device:
    one CDF up to ``STAGE_SPLIT_MIN`` qubits, three stages above.  A
    sharded state samples the same indices as its flat form with the same
    seed on the same device."""
    if is_sharded(re):
        return _sample_shards(re, im, num_qubits, num_samples, seed)
    gen = _generator(re.device, seed)
    if num_qubits <= STAGE_SPLIT_MIN:
        return _host_indices(_sample_direct(re * re + im * im, num_samples,
                                            gen))
    re2 = re.reshape(-1, DVIEW)
    im2 = im.reshape(-1, DVIEW)
    pr = torch.cat([(re2[s] * re2[s] + im2[s] * im2[s]).sum(dim=1)
                    for s in _row_chunks(re2.shape[0])])

    def columns(row):
        rre, rim = re2[row], im2[row]
        return rre * rre + rim * rim

    return _host_indices(_staged(pr, columns, num_samples, gen))


def _sample_shards(re, im, num_qubits, num_samples, seed):
    """``sample_state_device`` on a sharded state: the flat sampler's
    arithmetic, shard by shard, its reductions on the first shard's
    device."""
    first = re[0].device
    gen = _generator(first, seed)
    if num_qubits <= STAGE_SPLIT_MIN:
        p = torch.cat([(r * r + i * i).to(first) for r, i in zip(re, im)])
        return _host_indices(_sample_direct(p, num_samples, gen))
    rows = re[0].numel() // DVIEW            # rows of 256 a shard
    pr = []
    for r, i in zip(re, im):
        r2, i2 = r.reshape(-1, DVIEW), i.reshape(-1, DVIEW)
        pr += [(r2[s] * r2[s] + i2[s] * i2[s]).sum(dim=1).to(first)
               for s in _row_chunks(rows)]
    pr = torch.cat(pr)

    def columns(row):
        out = torch.empty((row.numel(), DVIEW), dtype=re[0].dtype,
                          device=first)
        shard, local = row // rows, row % rows
        for s, (r, i) in enumerate(zip(re, im)):
            sel = torch.nonzero(shard == s).squeeze(1)
            if sel.numel():
                at = local[sel].to(r.device)
                rre = r.reshape(-1, DVIEW)[at]
                rim = i.reshape(-1, DVIEW)[at]
                out[sel] = (rre * rre + rim * rim).to(first)
        return out

    return _host_indices(_staged(pr, columns, num_samples, gen))


def top_amplitudes_device(re, im, k: int = 8):
    """(probabilities, indices) of the k most likely outcomes; of a sharded
    state from each shard's k best (equal probabilities lower index
    first)."""
    if not is_sharded(re):
        vals, idx = torch.topk(re * re + im * im, k)
        return vals.cpu().numpy(), _host_indices(idx)
    first = re[0].device
    size = re[0].numel()
    vals, idx = [], []
    for s, (r, i) in enumerate(zip(re, im)):
        v, j = torch.topk(r * r + i * i, min(k, size))
        vals.append(v.to(first))
        idx.append(j.to(first) + s * size)
    vals, idx = torch.cat(vals), torch.cat(idx)
    order = torch.argsort(idx)
    order = order[torch.sort(vals[order], descending=True, stable=True)[1]]
    order = order[:k]
    return vals[order].cpu().numpy(), _host_indices(idx[order])


def _sq(x: torch.Tensor) -> float:
    """x . x in dot products of at most ``DOT_CHUNK`` elements (cuBLAS
    takes no longer vector: a shard of 2^32 amplitudes is two of them)."""
    return sum(float(torch.dot(p, p)) for p in x.reshape(-1).split(DOT_CHUNK))


def norm_device(re, im) -> float:
    """Squared norm of a flat state (dot products: no 2^n temporary), or
    of a sharded one (the shards' dot products summed)."""
    if is_sharded(re):
        return sum(_sq(r) + _sq(i) for r, i in zip(re, im))
    return _sq(re) + _sq(im)


def amplitudes_device(re, im, indices) -> np.ndarray:
    """Complex amplitudes of selected basis indices of a flat or sharded
    state: a gather of just len(indices) values on the devices."""
    idx = np.asarray(indices, dtype=np.int64)
    if not is_sharded(re):
        at = torch.from_numpy(idx).to(re.device)
        return re[at].cpu().numpy() + 1j * im[at].cpu().numpy()
    size = re[0].numel()
    out = np.empty(idx.shape, dtype=np.complex128)
    for k, j in enumerate(idx.reshape(-1)):
        s, local = divmod(int(j), size)
        out.reshape(-1)[k] = complex(float(re[s][local]), float(im[s][local]))
    return out.astype(np.complex64 if re[0].dtype == torch.float32
                      else np.complex128)


def norm_halves(re0, re1, im0, im1) -> float:
    """Squared norm of a column-half-split state."""
    return float(sum(torch.dot(h.reshape(-1), h.reshape(-1))
                     for h in (re0, re1, im0, im1)))


def _row_chunks(rows: int):
    for start in range(0, rows, CHUNK_ROWS):
        yield slice(start, min(start + CHUNK_ROWS, rows))


def _half_probs(re_h, im_h, rows):
    r, i = re_h[rows], im_h[rows]
    return r * r + i * i


def sample_halves(re0, re1, im0, im1, num_qubits: int, num_samples: int,
                  seed: int = 0) -> np.ndarray:
    """Sample basis-state indices from a split-half state: the three-stage
    sampler over the halves, without the 2^n probability vector."""
    gen = _generator(re0.device, seed)
    pr = torch.cat([(_half_probs(re0, im0, s) + _half_probs(re1, im1, s))
                    .sum(dim=1) for s in _row_chunks(re0.shape[0])])

    def columns(row):
        return torch.cat([_half_probs(re0, im0, row),
                          _half_probs(re1, im1, row)], dim=1)

    return _host_indices(_staged(pr, columns, num_samples, gen))


def measure_qubit_device(re, im, qubit: int, u: float):
    """Measure one qubit of a flat state (Born rule, projective).

    Returns (re, im, outcome) with the state collapsed and renormalized.
    ``u`` is the uniform [0, 1) draw deciding the outcome (callers own the
    RNG so trajectories are reproducible)."""
    shape = (-1, 2, 1 << qubit)
    p = (re * re + im * im).view(shape)
    total = p.sum()
    p1 = p[:, 1].sum()
    outcome = int(u * total < p1)
    mass = p1 if outcome else total - p1
    scale = torch.rsqrt(torch.clamp(mass, min=torch.finfo(re.dtype).tiny))
    out = []
    for x in (re, im):
        y = torch.zeros_like(x)
        y.view(shape)[:, outcome] = x.view(shape)[:, outcome] * scale
        out.append(y)
    return out[0], out[1], outcome


def _fold_z(p: torch.Tensor, bits) -> torch.Tensor:
    """Sum of ``p`` (2^m,) with the sign (-1)^(parity of the index bits
    ``bits``): one halving difference per bit, highest first."""
    for b in sorted(bits, reverse=True):
        v = p.view(-1, 2, 1 << b)
        p = (v[:, 0] - v[:, 1]).reshape(-1)
    return p.sum()


def expectation_z(re, im, qubits, num_qubits: int) -> float:
    """<Z_{q1} Z_{q2} ...> of a flat state (no state transfer); of a
    sharded one, each shard folded over its local qubits and signed by its
    index bits."""
    if not is_sharded(re):
        return float(_fold_z(re * re + im * im, set(qubits)))
    nl = re[0].numel().bit_length() - 1
    local = {q for q in qubits if q < nl}
    gmask = sum(1 << (q - nl) for q in set(qubits) if q >= nl)
    total = 0.0
    for s, (r, i) in enumerate(zip(re, im)):
        sign = -1.0 if bin(s & gmask).count("1") & 1 else 1.0
        total += sign * float(_fold_z(r * r + i * i, local))
    return total


def expectation_z_halves(re0, re1, im0, im1, qubits,
                         num_qubits: int) -> float:
    """<Z_{q1} Z_{q2} ...> of a column-half-split state: lane bits by a
    sign vector, qubit 7 by the half, row bits by folding the row sums.

    For X/Y strings append the basis rotations to the circuit before
    ``run_device_halves`` and reduce the rotated state here."""
    qubits = set(qubits)
    lane = torch.arange(LANES, device=re0.device)
    sign = torch.ones(LANES, device=re0.device, dtype=re0.dtype)
    for q in qubits:
        if q < 7:
            sign = sign * (1 - 2 * ((lane >> q) & 1)).to(re0.dtype)
    s1 = -sign if 7 in qubits else sign
    t = torch.cat([_half_probs(re0, im0, s) @ sign
                   + _half_probs(re1, im1, s) @ s1
                   for s in _row_chunks(re0.shape[0])])
    return float(_fold_z(t, {q - 8 for q in qubits if q >= 8}))


def top_amplitudes_halves(re0, re1, im0, im1, k: int = 8,
                          block_rows: int = 4096):
    """(indices, probabilities) of the k most probable basis states of a
    split-half state — exact, with at most one (block_rows, 256) tile of
    transient memory: row blocks are scanned with a running top-k."""
    R2 = re0.shape[0]
    block_rows = min(block_rows, R2)
    while R2 % block_rows:
        block_rows //= 2
    vals = torch.full((k,), -1.0, dtype=re0.dtype, device=re0.device)
    idx = torch.zeros(k, dtype=torch.int64, device=re0.device)
    for start in range(0, R2, block_rows):
        rows = slice(start, start + block_rows)
        p = torch.cat([_half_probs(re0, im0, rows),
                       _half_probs(re1, im1, rows)], dim=1).reshape(-1)
        bv, bi = torch.topk(p, min(k, p.numel()))
        cand_v = torch.cat([vals, bv])
        cand_i = torch.cat([idx, bi + start * DVIEW])
        vals, pick = torch.topk(cand_v, k)
        idx = cand_i[pick]
    # equal probabilities in the JAX package's order (lax.top_k keeps the
    # lower index first; torch.topk leaves ties in no set order)
    order = torch.argsort(idx)
    order = order[torch.sort(vals[order], descending=True, stable=True)[1]]
    return _host_indices(idx[order]), vals[order].cpu().numpy()


def amplitudes_halves(re0, re1, im0, im1, indices) -> np.ndarray:
    """Complex amplitudes of selected basis indices from a split state: a
    gather of just len(indices) values on the device."""
    idx = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(re0.device)
    row, col = idx >> 8, idx & 0xFF
    hi = col >= LANES
    lane = col & (LANES - 1)
    re = torch.where(hi, re1[row, lane], re0[row, lane]).cpu().numpy()
    im = torch.where(hi, im1[row, lane], im0[row, lane]).cpu().numpy()
    return re + 1j * im


def counts(samples, num_qubits: int, as_bitstrings: bool = True):
    """{outcome: count} from an array of sampled basis indices.

    ``as_bitstrings=True`` keys by MSB-first bitstrings (the CLI's
    MEASUREMENT rendering); otherwise by integer index."""
    idx, cnt = np.unique(np.asarray(samples), return_counts=True)
    if as_bitstrings:
        return {format(int(i), f"0{num_qubits}b"): int(c)
                for i, c in zip(idx, cnt)}
    return {int(i): int(c) for i, c in zip(idx, cnt)}


def xeb_fidelity(re, im, samples, num_qubits: int) -> float:
    """Linear cross-entropy benchmarking fidelity of a sample set against
    the ideal flat state on its device: F = 2^n <p(s)>_samples - 1.

    ~1 when the samples follow |psi|^2 (Porter-Thomas), ~0 for uniform
    noise.  Only the len(samples) gathered probabilities are read."""
    idx = torch.from_numpy(np.asarray(samples, dtype=np.int64)).to(re.device)
    p = re[idx] ** 2 + im[idx] ** 2
    return float((1 << num_qubits) * p.mean() - 1.0)
