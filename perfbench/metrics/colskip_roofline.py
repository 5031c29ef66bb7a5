"""Share of the roofline of the colskip kernel (``colskip.cu``): the
least time the card could take for the reference's column reads (each a
32-bit operation on each of the row's mask words) and the rows' bytes,
over the traced device time of the kernel."""

from perfbench.metrics._lib import machine_roofline


def read(ctx):
    return machine_roofline(ctx, "colskip",
                            ("colskip_sort_kernel", "colskip_dense_kernel"),
                            mesh=False)
