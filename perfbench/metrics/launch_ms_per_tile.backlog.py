"""Host milliseconds a machine tile in the backends' ``launch`` stage, the
launcher call: output allocation and the kernel's enqueue:
``colskip.launch`` and ``colskip_mesh.launch`` over those backends'
tiles in the window."""

from perfbench.metrics._stages import ms_per_tile

MACHINES = ("colskip", "colskip_mesh")


def read(ctx):
    return ms_per_tile(ctx, tuple(f"{b}.launch" for b in MACHINES),
                       MACHINES, key="s")
