"""Host milliseconds a machine tile in the backends' ``h2d`` stage, the
host array to a device tensor (the mesh's prefetch included):
``colskip.h2d`` and ``colskip_mesh.h2d`` over those backends' tiles in
the window."""

from perfbench.metrics._stages import ms_per_tile

MACHINES = ("colskip", "colskip_mesh")


def read(ctx):
    return ms_per_tile(ctx, tuple(f"{b}.h2d" for b in MACHINES),
                       MACHINES, key="s")
