"""Share of the roofline of the radix top-k kernel
(``radix_threshold.cu``, both instances): each radix tile's keys read once
and its outputs written once, at the card's HBM bandwidth, over the traced
device time of the kernel.  Tiles and their k come from the program's
request tracer."""

from perfbench.metrics._lib import Context
from perfbench.metrics._roofline import radix_tile_bytes, share_pct, \
    least_time_s

NEEDS = {"tracer"}


def read(ctx: Context):
    if ctx.tracer is None:
        return None
    k_of = {q.request_id: q.k for q in ctx.window["requests"]}
    tiles = {}
    for c in ctx.tracer.chains:
        rec = c["tile"]
        if c["rid"] in k_of and rec is not None \
                and rec.get("backend") == "radix_topk":
            kp = 1 << (int(k_of[c["rid"]]) - 1).bit_length()
            tiles[rec["seq"]] = (rec["shape"], max(kp, tiles.get(
                rec["seq"], ((0, 0), 0))[1]))
    nbytes = sum(radix_tile_bytes(b, n, k) for (b, n), k in tiles.values())
    if nbytes == 0:
        return None
    return share_pct(least_time_s(0, nbytes),
                     ctx.kernel_s("radix_threshold_kernel",
                                  "radix_narrow_kernel"))
