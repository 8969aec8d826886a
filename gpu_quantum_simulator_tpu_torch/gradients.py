"""Gradients of observable expectations w.r.t. gate parameters.

The port of ``gpu_quantum_simulator_tpu/gradients.py``.  The host half
(``parameterized_gates``, ``_shifted``, the shift rule and the tie
validation) is the JAX package's code; what ran under ``jax.jit`` there
is torch ops on the simulator's device here, queued without a host wait
until the one fetch of the result:

* ``parameter_shift`` evaluates exact gradients with two full circuit
  executions per parameter, so every engine doubles as a gradient
  engine.  Valid for the single-parameter rotation family — rz/rx/ry/p
  have generators with eigenvalues {0, ±1/2} (rz(θ) = diag(1, e^{iθ}),
  quantum_simulator.c:205-208 phase convention), for which
  dE/dθ = [E(θ + π/2) − E(θ − π/2)] / 2.
* ``adjoint_gradient``: one forward run through the Simulator (the
  ported kernels of its engine), then one backward sweep over the
  ``ops/apply.py`` primitives, ``apply_pauli_parts`` and ``inner_parts``.
* ``make_adjoint_value_and_grad``: forward and sweep both as torch ops,
  the rotation matrices of a call built in one vectorised pass from the
  parameter vector, the fixed gates' matrices uploaded once.  Members of
  a batch (``thetas`` of shape (K, P)) run as one (K, 2^n) state, which
  is how ``run_vqe(restarts=K)`` and ``energy_landscape`` batch — the
  counterpart of the JAX package's ``vmap``.

Every entry point that builds a Simulator or a state takes the port's
``device`` ("cuda" unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import SimulatorConfig
from .ir.circuit import Circuit
from .kernels.wide import ieee_fp32

SHIFT_RULE_GATES = ("rz", "rx", "ry", "p")


def parameterized_gates(circuit: Circuit) -> List[int]:
    """Indices of gates the shift rule differentiates."""
    return [
        i
        for i, g in enumerate(circuit.gates)
        if g.name in SHIFT_RULE_GATES and g.params
    ]


def _shifted(circuit: Circuit, gate_index: int, delta: float) -> Circuit:
    c = Circuit(circuit.num_qubits, list(circuit.gates))
    g = c.gates[gate_index]
    c.gates[gate_index] = type(g)(g.name, g.qubits, (g.params[0] + delta,))
    return c


def expectation(circuit: Circuit, z_qubits: Sequence[int],
                config: Optional[SimulatorConfig] = None,
                device="cuda") -> float:
    """<Z_{q1} Z_{q2} ...> after running ``circuit`` (device-side reduce)."""
    from .engine.simulator import Simulator
    from .sampling import expectation_z

    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)
    if cfg.strategy == "reference":  # host engine: reduce on host
        state = sim.run(circuit)
        zmask = 0
        for q in z_qubits:
            zmask |= 1 << q
        signs = 1.0 - 2.0 * (
            np.bitwise_count(np.arange(state.size) & zmask).astype(np.int64) & 1
        )
        return float(np.sum(signs * np.abs(state) ** 2))
    re, im, _ = sim.run_device(circuit)
    return expectation_z(re, im, z_qubits, circuit.num_qubits)


def parameter_shift(
    circuit: Circuit,
    z_qubits: Sequence[int] = (),
    config: Optional[SimulatorConfig] = None,
    gate_indices: Optional[Sequence[int]] = None,
    expectation_fn=None,
    device="cuda",
) -> Tuple[np.ndarray, List[int]]:
    """(gradient array, gate indices): d<Z...>/dθ_k for each rotation gate.

    2 executions per parameter; with ``strategy="prefetch"`` the shifted
    circuits share the program builder's caches.  ``expectation_fn(circuit)
    -> float`` replaces the default Z-string expectation — any objective
    that is a fixed functional of the circuit works (e.g. a noisy Pauli
    sum: the shift rule stays exact because the channels are
    θ-independent).
    """
    if expectation_fn is None:
        expectation_fn = lambda c: expectation(c, z_qubits, config, device)
    idxs = list(gate_indices) if gate_indices is not None else parameterized_gates(circuit)
    grads = np.zeros(len(idxs))
    for j, i in enumerate(idxs):
        plus = expectation_fn(_shifted(circuit, i, math.pi / 2))
        minus = expectation_fn(_shifted(circuit, i, -math.pi / 2))
        grads[j] = 0.5 * (plus - minus)
    return grads, idxs


def parameter_shift_noisy(
    circuit: Circuit,
    terms,
    shots: int = 4096,
    kind: str = "depolarizing",
    p1: float = 0.0,
    p2: float = 0.0,
    seed: int = 0,
    config: Optional[SimulatorConfig] = None,
    gate_indices: Optional[Sequence[int]] = None,
    device="cuda",
) -> Tuple[np.ndarray, List[int]]:
    """Parameter-shift gradient of a noisy Pauli-sum expectation.

    Each shifted evaluation is a batched trajectory ensemble
    (dynamic.expectation_noisy) with a FIXED seed, so the plus/minus
    pair shares the noise realizations — common-random-numbers variance
    reduction on top of the exact shift rule."""
    from .dynamic import expectation_noisy

    fn = lambda c: expectation_noisy(
        c, terms, shots=shots, kind=kind, p1=p1, p2=p2, seed=seed,
        config=config, device=device)
    return parameter_shift(circuit, (), config, gate_indices, fn, device)


def _adjoint_sweep(circuit: Circuit, terms, re, im, idxs) -> torch.Tensor:
    """The backward sweep of ``adjoint_gradient`` on the forward state
    (re, im): the gradient as a (len(idxs),) tensor on the state's device,
    queued, not fetched.  The undo matrices go up once, as one pinned
    table."""
    from .engine.naive import _upload_tables
    from .ir.gates import matrix_1q
    from .observables import _parse_pauli, apply_pauli_parts, inner_parts
    from .ops.apply import apply_1q, apply_cnot

    n = circuit.num_qubits
    gates = list(circuit.gates)
    idx_set = set(idxs)
    parsed = [(float(c), _parse_pauli(p, n)) for c, p in terms]
    undo = iter(_upload_tables(
        [matrix_1q(g.name, g.params).conj().T for g in reversed(gates)
         if g.name != "cx"], re))

    lr = torch.zeros_like(re)
    li = torch.zeros_like(im)
    for coeff, ops in parsed:
        tr, ti = apply_pauli_parts(re, im, ops, n)
        lr = lr + coeff * tr
        li = li + coeff * ti
    grads = {}
    pr, pi = re, im
    for k in range(len(gates) - 1, -1, -1):
        g = gates[k]
        if k in idx_set:
            q = g.qubits[0]
            hi, lo = 1 << (n - 1 - q), 1 << q
            if g.name in ("rz", "p"):
                # -2 Im <lambda| P1 |psi_k>
                one = [x.reshape(hi, 2, lo)[:, 1, :].reshape(-1)
                       for x in (lr, li, pr, pi)]
                _, zi = inner_parts(*one)
                grads[k] = -2.0 * zi
            else:
                ax = "X" if g.name == "rx" else "Y"
                xr, xi = apply_pauli_parts(pr, pi, {q: ax}, n)
                _, zi = inner_parts(lr, li, xr, xi)
                grads[k] = zi          # Im <lambda| {X,Y} |psi_k>
        # undo gate k on both vectors
        if g.name == "cx":
            pr, pi = apply_cnot(pr, pi, g.qubits[0], g.qubits[1], n)
            lr, li = apply_cnot(lr, li, g.qubits[0], g.qubits[1], n)
        else:
            ur, ui = next(undo)
            pr, pi = apply_1q(pr, pi, ur, ui, g.qubits[0], n)
            lr, li = apply_1q(lr, li, ur, ui, g.qubits[0], n)
    if not idxs:
        return torch.zeros(0, dtype=re.dtype, device=re.device)
    return torch.stack([grads[i] for i in idxs])


def adjoint_gradient(
    circuit: Circuit,
    terms=None,
    z_qubits: Sequence[int] = (),
    config: Optional[SimulatorConfig] = None,
    gate_indices: Optional[Sequence[int]] = None,
    device="cuda",
) -> Tuple[np.ndarray, List[int]]:
    """(gradient array, gate indices) by ADJOINT differentiation.

    One forward execution (any engine) + ONE backward sweep computes the
    gradient of <H> w.r.t. EVERY rotation parameter simultaneously —
    O(1) circuit-equivalents total vs parameter-shift's 2 per parameter.
    The sweep walks the gate list in reverse, undoing each gate on both
    the state and the adjoint vector lambda = H psi; a parameterized
    gate's gradient is a sparse inner product between the two
    (rz/p: masked product on the qubit's |1> half, dU = i P1 U;
    rx/ry: a flip/Y product, dU = -(i/2) {X,Y} U).

    ``terms``: Pauli-sum spec [(coeff, "Z0 Z1"), ...]; ``z_qubits`` is the
    single-Z-string shorthand.  The forward run is queued on the device
    (``Simulator._run_device``) and the sweep after it; nothing waits for
    the device until the gradient vector is fetched, once.  psi, lambda
    and the contraction temporaries are resident together (about eight
    state-sized float32 buffers).
    """
    from .engine.simulator import Simulator

    if terms is None:
        terms = [(1.0, " ".join(f"Z{q}" for q in z_qubits))]
    cfg = config or SimulatorConfig()
    sim = Simulator(cfg, device=device)
    idxs = (list(gate_indices) if gate_indices is not None
            else parameterized_gates(circuit))
    for i in set(idxs):
        if circuit.gates[i].name not in SHIFT_RULE_GATES:
            raise ValueError(
                f"gate {circuit.gates[i].name!r} has no adjoint rule")

    re, im, _ = sim._run_device(circuit)
    grads = _adjoint_sweep(circuit, terms, re, im, idxs)
    return grads.double().cpu().numpy(), idxs


# ----------------------------------------------------- compiled value+grad
def _rotation_coeffs(name: str):
    """(half, B, A, Dr, Di) of a rotation: with c = cos(half * angle) and
    s = sin(half * angle), U = B + c A + s Dr + i s Di, and U^dag flips the
    sign of s (the JAX package's ``mat_1q``)."""
    z = np.zeros((2, 2))
    if name in ("rz", "p"):
        one = np.array([[0.0, 0.0], [0.0, 1.0]])
        return 1.0, np.array([[1.0, 0.0], [0.0, 0.0]]), one, z, one
    if name == "rx":
        return 0.5, z, np.eye(2), z, -np.array([[0.0, 1.0], [1.0, 0.0]])
    if name == "ry":
        return 0.5, z, np.eye(2), np.array([[0.0, -1.0], [1.0, 0.0]]), z
    raise AssertionError(name)  # fixed gates take the constant path


def _apply_1q_rows(re, im, ur, ui, q: int, n: int):
    """A 2x2 gate on qubit q of every row of (K, 2^n) parts: ``ur``/``ui``
    (2, 2) shared by the rows or (K, 2, 2) one per row."""
    hi, lo = 1 << (n - q - 1), 1 << q
    shape = (re.shape[0], hi, 2, lo)
    eq = "ab,kxbz->kxaz" if ur.dim() == 2 else "kab,kxbz->kxaz"
    r, i = re.reshape(shape), im.reshape(shape)
    with ieee_fp32():
        nre = torch.einsum(eq, ur, r) - torch.einsum(eq, ui, i)
        nim = torch.einsum(eq, ur, i) + torch.einsum(eq, ui, r)
    return nre.reshape(re.shape), nim.reshape(im.shape)


def _inner_rows(lr, li, pr, pi):
    """Per-row <lambda|psi> of (K, m) parts: (Re, Im), each (K,)."""
    return ((lr * pr).sum(-1) + (li * pi).sum(-1),
            (lr * pi).sum(-1) - (li * pr).sum(-1))


def make_adjoint_value_and_grad(
    circuit: Circuit,
    terms,
    config: Optional[SimulatorConfig] = None,
    tie=None,
    _value_only: bool = False,
    device="cuda",
):
    """Build ONE ``f(thetas) -> (<H>, grads)`` for optimizer loops.

    The rotation parameters of ``circuit`` become an input vector (order =
    the returned ``idxs``), so a VQE/QAOA optimizer iterates with nothing
    rebuilt: forward applies every gate as torch ops on the device
    (parameterized matrices built from ``thetas`` in one vectorised pass a
    call, fixed gates' matrices uploaded once when ``f`` is built), then
    the adjoint sweep of ``adjoint_gradient`` runs on the same state.
    Returns ``(fn, idxs, theta0)`` with ``theta0`` = the circuit's current
    values; ``fn`` returns a 0-d and a 1-d tensor on the device.
    ``thetas`` of shape (K, P) evaluates K parameter vectors as one
    (K, 2^n) state and returns (K,) and (K, P).

    ``tie`` shares one parameter across many gates (the QAOA pattern:
    every edge's rz carries the same gamma): a mapping
    ``{gate_index: (slot, scale)}`` meaning gate k's angle is
    ``scale * thetas[slot]``.  Gradients apply the chain rule — slot s
    accumulates ``scale_k * dE/dangle_k`` over its gates — so one adjoint
    sweep yields exact d<H>/dgamma_l, d<H>/dbeta_l for a p-layer QAOA.
    With ``tie``, rotation gates NOT in the map stay constant, ``theta0``
    is slot-indexed (read off the first gate carrying each slot), and the
    returned ``idxs`` lists the tied gate indices.
    """
    from .observables import _parse_pauli, apply_pauli_parts
    from .ops.apply import apply_cnot, resolve_device, upload

    cfg = config or SimulatorConfig()
    real_dtype = torch.float64 if cfg.dtype == "complex128" else torch.float32
    np_dtype = np.float64 if cfg.dtype == "complex128" else np.float32
    dev = resolve_device(device)
    n = circuit.num_qubits
    if tie is None:
        idxs = parameterized_gates(circuit)
        pos_of = {g: (j, 1.0) for j, g in enumerate(idxs)}
        num_slots = len(idxs)
        theta0 = np.array([circuit.gates[i].params[0] for i in idxs])
    else:
        pos_of = {}
        for k, (slot, scale) in tie.items():
            g = circuit.gates[k]
            if g.name not in SHIFT_RULE_GATES or not g.params:
                raise ValueError(
                    f"tied gate {k} ({g.name!r}) has no adjoint rule")
            if float(scale) == 0.0:
                raise ValueError(f"tied gate {k} has zero scale")
            pos_of[int(k)] = (int(slot), float(scale))
        idxs = sorted(pos_of)
        slots = {s for s, _ in pos_of.values()}
        num_slots = 1 + max(slots) if slots else 0
        if slots != set(range(num_slots)):
            raise ValueError(f"tie slots {sorted(slots)} are not contiguous")
        theta0 = np.zeros(num_slots)
        seen = set()
        for k in idxs:
            s, sc = pos_of[k]
            if s not in seen:
                seen.add(s)
                theta0[s] = circuit.gates[k].params[0] / sc
    gates = list(circuit.gates)
    parsed = [(float(c), _parse_pauli(p, n)) for c, p in terms]

    # Host tables, uploaded once: per parameterized gate its slot, scale
    # times half-angle factor and rotation coefficients; per fixed gate
    # its matrix and adjoint; the chain-rule map (slots x tied gates).
    tied = [k for k in range(len(gates)) if k in pos_of]
    col_of = {k: j for j, k in enumerate(tied)}
    fixed = [k for k in range(len(gates))
             if k not in pos_of and gates[k].name != "cx"]
    fix_of = {k: j for j, k in enumerate(fixed)}
    slot_idx = np.array([pos_of[k][0] for k in tied], dtype=np.int64)
    coef = np.zeros((4, len(tied), 2, 2))
    factor = np.zeros(len(tied))
    chain = np.zeros((num_slots, len(tied)))
    for j, k in enumerate(tied):
        half, *mats = _rotation_coeffs(gates[k].name)
        s, sc = pos_of[k]
        factor[j] = half * sc
        coef[:, j] = mats
        chain[s, j] = sc
    fmats = np.zeros((2, 2, len(fixed), 2, 2))
    for j, k in enumerate(fixed):
        u = gates[k].matrix()
        fmats[0, :, j] = (u.real, u.imag)
        u = u.conj().T
        fmats[1, :, j] = (u.real, u.imag)
    coef_t = upload(coef.astype(np_dtype), dev)
    factor_t = upload(factor.astype(np_dtype), dev)
    slot_t = upload(slot_idx, dev)
    chain_t = upload(chain.astype(np_dtype), dev)
    fixed_t = upload(fmats.astype(np_dtype), dev)

    def gate_mats(thetas):
        """(K, G, 2, 2) forward and adjoint (re, im) of every tied gate."""
        ang = thetas[:, slot_t] * factor_t                 # (K, G)
        c = torch.cos(ang)[..., None, None]
        s = torch.sin(ang)[..., None, None]
        b, a, dr, di = coef_t
        base = b + c * a
        return (base + s * dr, s * di), (base - s * dr, -s * di)

    def fn(thetas):
        thetas = torch.as_tensor(thetas, dtype=real_dtype, device=dev)
        batched = thetas.dim() == 2
        if not batched:
            thetas = thetas[None]
        kk = thetas.shape[0]
        (fr, fi), (br, bi) = gate_mats(thetas)

        def cnot(re, im, g):           # on every row's state
            re, im = apply_cnot(re.reshape(-1), im.reshape(-1), *g.qubits,
                                n, rows=kk)
            return re.view(kk, -1), im.view(kk, -1)

        def pauli(re, im, ops):
            re, im = apply_pauli_parts(re.reshape(-1), im.reshape(-1), ops,
                                       n, rows=kk)
            return re.view(kk, -1), im.view(kk, -1)

        pr = torch.zeros((kk, 1 << n), dtype=real_dtype, device=dev)
        pr[:, :1].fill_(1.0)
        pi = torch.zeros_like(pr)
        for k, g in enumerate(gates):
            if g.name == "cx":
                pr, pi = cnot(pr, pi, g)
                continue
            if k in pos_of:
                j = col_of[k]
                ur, ui = fr[:, j], fi[:, j]
            else:
                ur, ui = fixed_t[0, :, fix_of[k]]
            pr, pi = _apply_1q_rows(pr, pi, ur, ui, g.qubits[0], n)
        lr = torch.zeros_like(pr)
        li = torch.zeros_like(pi)
        for coeff, ops in parsed:
            tr, ti = pauli(pr, pi, ops)
            lr = lr + coeff * tr
            li = li + coeff * ti
        energy, _ = _inner_rows(pr, pi, lr, li)
        if _value_only:
            gvec = torch.zeros((kk, 0), dtype=real_dtype, device=dev)
        else:
            contrib = [None] * len(tied)
            for k in range(len(gates) - 1, -1, -1):
                g = gates[k]
                if k in pos_of:
                    q = g.qubits[0]
                    hi, lo = 1 << (n - 1 - q), 1 << q
                    if g.name in ("rz", "p"):
                        one = [x.reshape(kk, hi, 2, lo)[:, :, 1, :]
                               .reshape(kk, -1) for x in (lr, li, pr, pi)]
                        _, zi = _inner_rows(*one)
                        contrib[col_of[k]] = -2.0 * zi
                    else:
                        ax = "X" if g.name == "rx" else "Y"
                        xr, xi = pauli(pr, pi, {q: ax})
                        _, zi = _inner_rows(lr, li, xr, xi)
                        contrib[col_of[k]] = zi
                if g.name == "cx":
                    pr, pi = cnot(pr, pi, g)
                    lr, li = cnot(lr, li, g)
                    continue
                if k in pos_of:
                    j = col_of[k]
                    ur, ui = br[:, j], bi[:, j]
                else:
                    ur, ui = fixed_t[1, :, fix_of[k]]
                pr, pi = _apply_1q_rows(pr, pi, ur, ui, g.qubits[0], n)
                lr, li = _apply_1q_rows(lr, li, ur, ui, g.qubits[0], n)
            if tied:
                with ieee_fp32():
                    gvec = torch.stack(contrib, 1) @ chain_t.T   # (K, slots)
            else:
                gvec = torch.zeros((kk, num_slots), dtype=real_dtype,
                                   device=dev)
        if not batched:
            return energy[0], gvec[0]
        return energy, gvec

    return fn, idxs, theta0


def _default_optimizer(learning_rate: float):
    """optax.adam(learning_rate)'s update as a torch optimizer: the same
    rule with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return lambda params: torch.optim.Adam(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def run_vqe(
    circuit: Circuit,
    terms,
    steps: int = 100,
    learning_rate: float = 0.05,
    optimizer=None,
    tie=None,
    maximize: bool = False,
    config: Optional[SimulatorConfig] = None,
    restarts: int = 0,
    spread: float = 0.5,
    seed: int = 0,
    device="cuda",
):
    """Run a whole variational optimization ON THE DEVICE: ``steps`` adam
    updates, each an adjoint value-and-grad sweep, with no host wait in
    the loop.

    ``optimizer``: a callable ``params -> torch.optim.Optimizer`` over the
    list of parameter tensors (in place of the JAX package's optax
    transform); the default is ``torch.optim.Adam`` with optax.adam's
    defaults, the same update rule.  ``maximize=True`` ascends (QAOA's
    <C>).  Returns ``(theta_final, energies)`` with ``energies`` the
    per-step values BEFORE each update (host numpy, fetched once).

    ``restarts=K`` runs the K optimizations as ONE batched sweep over K
    initial points (the circuit's own angles plus K-1 uniform
    perturbations of width ``spread``, the JAX package's draws) and keeps
    the best final energy — K states resident.
    """
    fn, theta, es = _vqe_device(
        circuit, terms, steps, learning_rate, optimizer, tie, maximize,
        config, restarts, spread, seed, device)
    if theta.dim() == 2:
        with torch.no_grad():
            finals, _ = fn(theta)
        finals = finals.cpu().numpy()
        best = int(np.argmax(finals) if maximize else np.argmin(finals))
        return theta[best].cpu().numpy(), es[best].cpu().numpy()
    return theta.cpu().numpy(), es.cpu().numpy()


def _vqe_device(circuit, terms, steps, learning_rate, optimizer, tie,
                maximize, config, restarts, spread, seed, device):
    """``run_vqe``'s loop, queued on the device and not fetched: returns
    ``(fn, theta, energies)`` with theta (P,) or (K, P) and energies
    (steps,) or (K, steps) as device tensors."""
    from .ops.apply import resolve_device, upload

    dev = resolve_device(device)
    fn, idxs, theta0 = make_adjoint_value_and_grad(
        circuit, terms, config=config, tie=tie, device=dev)
    make_opt = (optimizer if optimizer is not None
                else _default_optimizer(learning_rate))
    sign = -1.0 if maximize else 1.0
    cfg = config or SimulatorConfig()
    np_dtype = np.float64 if cfg.dtype == "complex128" else np.float32

    if restarts and restarts > 1:
        rng = np.random.default_rng(seed)
        inits = np.tile(np.asarray(theta0), (restarts, 1))
        inits[1:] += rng.uniform(-spread, spread,
                                 size=(restarts - 1, len(theta0)))
    else:
        inits = np.asarray(theta0)
    theta = upload(inits.astype(np_dtype), dev).requires_grad_(True)
    opt = make_opt([theta])
    energies = []
    for _ in range(steps):
        with torch.no_grad():
            e, g = fn(theta.detach())
        energies.append(e)
        theta.grad = sign * g
        opt.step()
    es = (torch.stack(energies, -1) if energies
          else torch.zeros(inits.shape[:-1] + (0,), device=dev))
    return fn, theta.detach(), es


def energy_landscape(
    circuit: Circuit,
    terms,
    thetas,
    tie=None,
    config: Optional[SimulatorConfig] = None,
    max_batch_log2: int = 24,
    device="cuda",
) -> np.ndarray:
    """<H> over a (G, P) grid of parameter vectors, batched on the device.

    Forward passes only (no adjoint sweep); chunked so a batch never
    exceeds 2^max_batch_log2 amplitudes; the chunks are queued and their
    values fetched once.  The QAOA p=1 (gamma, beta) heatmap in two lines:

        g, b = np.meshgrid(gs, bs, indexing="ij")
        E = energy_landscape(c, cost, np.stack([g, b], -1).reshape(-1, 2),
                             tie=tie).reshape(g.shape)
    """
    return _landscape_device(circuit, terms, thetas, tie, config,
                             max_batch_log2, device).cpu().numpy()


def _landscape_device(circuit, terms, thetas, tie, config, max_batch_log2,
                      device) -> torch.Tensor:
    """``energy_landscape``'s chunks, queued on the device: the (G,)
    energies as a device tensor, not fetched."""
    from .ops.apply import resolve_device, upload

    dev = resolve_device(device)
    fn, idxs, _ = make_adjoint_value_and_grad(
        circuit, terms, config=config, tie=tie, _value_only=True,
        device=dev)
    thetas = np.asarray(thetas, dtype=float)
    if thetas.ndim != 2:
        raise ValueError(f"thetas must be (grid, params), got {thetas.shape}")
    cfg = config or SimulatorConfig()
    np_dtype = np.float64 if cfg.dtype == "complex128" else np.float32

    n = circuit.num_qubits
    per = max(1, 1 << max(0, max_batch_log2 - n))
    out = []
    for lo in range(0, thetas.shape[0], per):
        chunk = upload(thetas[lo:lo + per].astype(np_dtype), dev)
        out.append(fn(chunk)[0])
    if not out:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    return torch.cat(out)
