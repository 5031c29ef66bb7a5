"""Measured-vs-modeled calibration probes.

The §V cost model predicts cycles; the wall clock measures seconds.  The
ratio between them — per (backend, tile width) — is the seed data any
real-silicon tuning pass needs: a backend whose measured wall time is 40x
its modeled ``cycles / clock_hz`` is running in software simulation, one
near 1.0 is tracking the modeled part, and a *drifting* ratio means the
cost model's routing priors no longer describe the machine they route for.

:class:`CalibrationTable` aggregates one probe per executed tile:
``record(backend, width, wall_s, modeled_cycles)`` accumulates per-(backend,
width) sums, and ``table()`` renders the telemetry section

    calibration.<backend>.<width>.{tiles, wall_s, modeled_s, ratio}

with ``ratio = wall_s / modeled_s`` (>1: slower than the modeled hardware).

The engine records **warm executions only** — the same gate the routing
EMA uses: a cold run's wall time is dominated by the one-time AOT compile
and would poison the ratio exactly as it would poison the EMA.  Backends
with no modeled cycles (the numpy oracle, radix plane reads) contribute no
rows: a ratio needs both domains.
"""

from __future__ import annotations

from repro_torch.core.costmodel import BASE_CLOCK_MHZ

__all__ = ["CalibrationTable"]


class CalibrationTable:
    """Per-(backend, width) measured-vs-modeled accumulator."""

    def __init__(self, clock_hz: float = BASE_CLOCK_MHZ * 1e6):
        if clock_hz <= 0:
            raise ValueError("clock_hz must be positive")
        self.clock_hz = float(clock_hz)
        # (backend, width) -> [tiles, wall_s_sum, modeled_cycles_sum]
        self._sums: dict[tuple[str, int], list] = {}

    def record(self, backend: str, width: int, wall_s: float,
               modeled_cycles: float) -> None:
        key = (backend, int(width))
        row = self._sums.get(key)
        if row is None:
            self._sums[key] = [1, float(wall_s), float(modeled_cycles)]
        else:
            row[0] += 1
            row[1] += float(wall_s)
            row[2] += float(modeled_cycles)

    def ratio(self, backend: str, width: int) -> float | None:
        """Aggregate wall/modeled ratio for one cell, or None if unseen."""
        row = self._sums.get((backend, int(width)))
        if row is None or row[2] <= 0:
            return None
        return row[1] / (row[2] / self.clock_hz)

    def table(self) -> dict:
        """Nested telemetry section, widths as strings (JSON dict keys)."""
        out: dict[str, dict] = {}
        for (backend, width), (tiles, wall, cyc) in sorted(self._sums.items()):
            modeled_s = cyc / self.clock_hz
            out.setdefault(backend, {})[str(width)] = {
                "tiles": tiles,
                "wall_s": wall,
                "modeled_s": modeled_s,
                "ratio": wall / modeled_s if modeled_s > 0 else 0.0,
            }
        return out

    def profile_rows(self) -> list[dict]:
        """Flat JSON rows for a tuned-hardware profile.

        ``scripts/hw_tune.py`` embeds these under the profile's
        ``calibration`` key; a serving process started with
        ``--hw-profile`` feeds them back through :meth:`seed_rows` so the
        measured-vs-modeled table opens with the bench harness's priors
        instead of empty cells."""
        rows = []
        for (backend, width), (tiles, wall, cyc) in sorted(self._sums.items()):
            modeled_s = cyc / self.clock_hz
            rows.append({
                "backend": backend, "width": int(width), "tiles": tiles,
                "wall_s": wall, "modeled_cycles": cyc,
                "ratio": wall / modeled_s if modeled_s > 0 else 0.0,
            })
        return rows

    def seed_rows(self, rows) -> int:
        """Warm-start from :meth:`profile_rows` output.

        Cells this process has already measured live are left alone — a
        fresh probe outranks a shipped prior.  Returns rows applied."""
        applied = 0
        for row in rows:
            key = (str(row["backend"]), int(row["width"]))
            if key in self._sums or float(row.get("modeled_cycles", 0)) <= 0:
                continue
            self._sums[key] = [int(row["tiles"]), float(row["wall_s"]),
                               float(row["modeled_cycles"])]
            applied += 1
        return applied

    def snapshot(self) -> dict:
        return {k: list(v) for k, v in self._sums.items()}

    def restore(self, snap: dict) -> None:
        self._sums = {k: list(v) for k, v in snap.items()}
