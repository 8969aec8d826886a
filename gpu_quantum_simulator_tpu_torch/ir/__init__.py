from . import gates
from .circuit import Gate, Circuit

__all__ = ["gates", "Gate", "Circuit"]
