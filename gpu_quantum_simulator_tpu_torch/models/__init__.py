from .circuits import (
    bell,
    ghz,
    random_circuit,
    grover_like,
    GROVER_3_18_PROFILE,
)

__all__ = [
    "bell",
    "ghz",
    "random_circuit",
    "grover_like",
    "GROVER_3_18_PROFILE",
]
