"""What the stage readers share: the growth over the window of the
program's stage table (``telemetry()["stages"]``: ``{name: {"n", "s",
"self_s"}}``, the engine's :class:`repro_torch.obs.tracer.Stages`) per
tile.  A program without the table gives no number."""

from __future__ import annotations


def stage_s(ctx, names, key: str = "self_s") -> float | None:
    """Seconds the stages ``names`` grew by over the window (``key``:
    ``"s"``, the spans' time, or ``"self_s"``, less the spans they
    enclose); None when the program keeps no stage table."""
    if "stages" not in ctx.marks["close"]["telemetry"]:
        return None
    return sum(ctx.delta("stages", name, key) for name in names)


def ms_per_tile(ctx, names, backends=None,
                key: str = "self_s") -> float | None:
    """``stage_s`` over the window's tiles of ``backends`` (every
    backend's when None), in milliseconds."""
    seconds = stage_s(ctx, names, key)
    if seconds is None:
        return None
    if backends is None:
        backends = ctx.marks["close"]["telemetry"]["per_backend"]
    tiles = sum(ctx.backend_tiles(b) for b in backends)
    return seconds / tiles * 1e3 if tiles > 0 else None
