"""The port's builders run on the card unless the caller asks for the CPU.

Each engine-level entry point, called without ``device``, takes the card;
on a host without one it raises the Simulator's RuntimeError instead of
falling back to the CPU (``torch.cuda.is_available`` is patched to False,
so the test means the same on a host with a card).
"""

import numpy as np
import pytest
import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch.engine import megakernel as TM
from gpu_quantum_simulator_tpu_torch.engine import pallas_engine as TP
from gpu_quantum_simulator_tpu_torch.engine import prefetch as TPF
from gpu_quantum_simulator_tpu_torch.engine import vmem as TV
from gpu_quantum_simulator_tpu_torch.engine import wide as TW
from gpu_quantum_simulator_tpu_torch.engine.simulator import _fuse_pipeline
from gpu_quantum_simulator_tpu_torch.ops import apply as TA
from gpu_quantum_simulator_tpu_torch.passes.shard import plan_sharded

N = 10


def _ops():
    return _fuse_pipeline(T.models.grover_like(N, 60, 2), 7, max_high=2)


BUILDERS = {
    "PrefetchProgram": lambda: TPF.PrefetchProgram(_ops(), N),
    "build_prefetch_program": lambda: TPF.build_prefetch_program(_ops(), N),
    "PrefetchProgram_inplace": lambda: TPF.PrefetchProgram(
        _ops(), N, inplace=True),
    "build_prefetch_program_inplace": lambda: TPF.build_prefetch_program(
        _ops(), N, inplace=True, fold_xswap=True),
    "initial_halves": lambda: TPF.initial_halves(N),
    "WideProgram": lambda: TW.WideProgram(_ops(), N),
    "build_wide_program": lambda: TW.build_wide_program(_ops(), N),
    "PallasProgram": lambda: TP.PallasProgram(
        plan_sharded(_ops(), N, N - 7), N),
    "initial_state_parts": lambda: TA.initial_state_parts(N),
    "split_state": lambda: TA.split_state(np.zeros(1 << N, np.complex64)),
    "build_megakernel": lambda: TM.build_megakernel(_ops(), N),
    "build_vmem_program": lambda: TV.build_vmem_program(_ops(), N),
    "build_vmem_program_cached": lambda: TV.build_vmem_program_cached(
        _ops(), N),
    "Simulator": lambda: T.Simulator(),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'.*pass device='cpu'"):
        BUILDERS[name]()
