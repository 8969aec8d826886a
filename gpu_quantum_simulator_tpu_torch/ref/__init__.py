from .cpu import (cumulative_distribution, initial_state, sample,
                  simulate_reference)
from .native import NativeUnavailable, simulate_native

__all__ = ["NativeUnavailable", "simulate_native", "cumulative_distribution",
           "initial_state", "sample", "simulate_reference"]
