from .cpu import (cumulative_distribution, initial_state, sample,
                  simulate_reference)
from .native import (NativeUnavailable, available, parse_qasm_native,
                     sample_native, simulate_native)

__all__ = ["NativeUnavailable", "available", "parse_qasm_native",
           "sample_native", "simulate_native", "cumulative_distribution",
           "initial_state", "sample", "simulate_reference"]
