"""Host milliseconds of a radix tile's body: the backend's
``radix_topk.h2d``, ``.launch`` and ``.d2h`` stages over the window's
radix tiles."""

from perfbench.metrics._stages import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, ("radix_topk.h2d", "radix_topk.launch",
                             "radix_topk.d2h"), ("radix_topk",), key="s")
