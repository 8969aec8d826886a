"""The port's roofline accounting (utils/roofline.py) against the JAX
package's: the same operation and byte counts, the card's denominators."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.engine.simulator import _fuse_pipeline as j_fuse
from gpu_quantum_simulator_tpu.utils import roofline as JR

from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline as t_fuse
from gpu_quantum_simulator_tpu_torch.utils import roofline as TR


@pytest.mark.parametrize("n", [12, 18, 24])
def test_wide_program_cost_counts_like_jax(n):
    ops = t_fuse(TM.grover_like(n, 600, 318), 7, max_high=2, window=8,
                 cost_model=True)
    jops = j_fuse(JM.grover_like(n, 600, 318), 7, max_high=2, window=8,
                  cost_model=True)
    got, want = TR.wide_program_cost(ops, n), JR.wide_program_cost(jops, n)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    assert got.arithmetic_intensity == want.arithmetic_intensity
    # the card's bound: the larger of fp32 operations and bytes at peak
    assert got.seconds() == max(got.flops / 67e12, got.hbm_bytes / 3.35e12)
    assert got.seconds(TR.H100_BF16_FLOPS) <= got.seconds()
    assert got.seconds(hbm_bw=TR.COPY_BYTES_PER_S) >= got.seconds()


@pytest.mark.parametrize("g1,cx,n", [(2000, 445, 18), (1, 0, 30), (0, 7, 9)])
def test_reference_gate_cost_counts_like_jax(g1, cx, n):
    got = TR.reference_gate_cost(g1, cx, n)
    want = JR.reference_gate_cost(g1, cx, n)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)


def test_card_rates_and_no_tpu_figure():
    """The denominators are the H100 80GB HBM3's: its datasheet peaks and,
    below the memory peak, the copy rate kernel 11 measured; the module
    keeps no figure of the JAX package's chip (its kh calibration aside,
    which only ranks blocks)."""
    assert (TR.H100_HBM_BYTES_PER_S, TR.H100_F32_FLOPS,
            TR.H100_BF16_FLOPS) == (3.35e12, 67e12, 989e12)
    assert 2.5e12 < TR.COPY_BYTES_PER_S < TR.H100_HBM_BYTES_PER_S
    assert not [k for k in vars(TR) if "V5E" in k.upper()]
    assert TR.kh_block_costs(18) == JR.kh_block_costs(18)
    assert TR.kh_block_costs(24) == JR.kh_block_costs(24)
    assert np.isclose(TR.CostModel(0.0, 3.35e12).seconds(), 1.0)
