from .ops import (
    radix_topk,
    radix_topk_threshold,
    threshold_sortable,
    topk_mask_from_threshold,
)

__all__ = ["radix_topk", "radix_topk_threshold", "threshold_sortable",
           "topk_mask_from_threshold"]
