"""Host milliseconds a machine tile in the backends' ``d2h`` stage, from
the launch's return to the last result on the host: the wait for the
kernel and the synchronising copies: ``colskip.d2h`` and
``colskip_mesh.d2h`` over those backends' tiles in the window."""

from perfbench.metrics._stages import ms_per_tile

MACHINES = ("colskip", "colskip_mesh")


def read(ctx):
    return ms_per_tile(ctx, tuple(f"{b}.d2h" for b in MACHINES),
                       MACHINES, key="s")
