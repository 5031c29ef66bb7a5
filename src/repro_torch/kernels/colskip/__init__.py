from .ops import colskip_sort_batched

__all__ = ["colskip_sort_batched"]
