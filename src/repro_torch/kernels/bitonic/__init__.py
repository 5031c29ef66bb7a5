from .ops import bitonic_sort
from .ref import n_passes

__all__ = ["bitonic_sort", "n_passes"]
