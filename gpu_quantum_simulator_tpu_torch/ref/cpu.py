"""Host-side measurement sampling on numpy.

A JAX-free copy of ``cumulative_distribution`` and ``sample`` from
``gpu_quantum_simulator_tpu/ref/cpu.py``: with the same
``np.random.default_rng(seed)`` both packages draw the same samples, bit
for bit.  The Simulator uses it up to n = 22; wider states are sampled on
the device (sampling.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def cumulative_distribution(v: np.ndarray) -> np.ndarray:
    """Inclusive prefix sum of |amp|^2 (ref: quantum_simulator.c:256-268)."""
    return np.cumsum(np.abs(v) ** 2)


def sample(
    v: np.ndarray,
    num_samples: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Inverse-CDF measurement sampling (ref: quantum_simulator.c:270-283).

    Returns int64 basis-state indices.  The reference walks the cumulative
    array linearly and skips zero-probability prefixes; searchsorted with
    side='left' on u in (0,1] is equivalent.
    """
    rng = rng or np.random.default_rng()
    cumul = cumulative_distribution(v)
    total = cumul[-1]
    u = rng.uniform(0.0, total, size=num_samples)
    return np.searchsorted(cumul, u, side="left").astype(np.int64)
