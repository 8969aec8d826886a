from .cpu import cumulative_distribution, sample
from .native import NativeUnavailable, simulate_native

__all__ = ["NativeUnavailable", "simulate_native", "cumulative_distribution",
           "sample"]
