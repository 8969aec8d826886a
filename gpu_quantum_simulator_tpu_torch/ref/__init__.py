from .native import NativeUnavailable, simulate_native

__all__ = ["NativeUnavailable", "simulate_native"]
