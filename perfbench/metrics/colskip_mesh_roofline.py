"""Share of the roofline of the colskip mesh kernel (``colskip_mesh.cu``):
the same work count as the one-bank kernel's (the inputs need the same
column reads on any number of banks, §V.C), over the traced device time
of the mesh kernel."""

from perfbench.metrics._lib import machine_roofline


def read(ctx):
    return machine_roofline(ctx, "colskip_mesh",
                            ("colskip_mesh_kernel",
                             "colskip_mesh_dense_kernel"), mesh=True)
