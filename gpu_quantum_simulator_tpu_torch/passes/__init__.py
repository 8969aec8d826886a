from .fuse4x4 import fuse_4x4
from .fuse_k import fuse_k
from .permute import plan_permutation, apply_permutation_to_ops, unpermute_state

__all__ = [
    "fuse_4x4",
    "fuse_k",
    "plan_permutation",
    "apply_permutation_to_ops",
    "unpermute_state",
]
