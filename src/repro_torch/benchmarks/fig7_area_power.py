"""Paper Fig. 7 — normalized area/power and efficiencies vs k (MapReduce).

Area/power come from the calibrated component model; cycles/number from the
hardware simulator on the MapReduce dataset.  Checks:
  * area grows monotonically with k (larger state controller),
  * area efficiency at k=1 >= 3x baseline (paper: "more than 3.2x"),
  * energy efficiency peaks at k=2 (paper §V.B).

A copy of the reference's ``benchmarks/fig7_area_power.py`` on
:mod:`repro_torch.core` (numpy on the host; ``device`` is unused).
"""

from __future__ import annotations

from .paper_common import KS, colskip_cycles_per_num, timed
from repro_torch.core.costmodel import baseline_cost, colskip_cost


def run(report, device="cuda"):
    base = baseline_cost()
    rows = {}
    for k in KS:
        cyc, us = timed(colskip_cycles_per_num, "mapreduce", k)
        c = colskip_cost(cyc, k=k)
        rows[k] = dict(
            cyc=cyc,
            area_x=c.area_kum2 / base.area_kum2,
            power_x=c.power_mw / base.power_mw,
            ae_x=c.area_eff / base.area_eff,
            ee_x=c.energy_eff / base.energy_eff,
            us=us,
        )
    areas = [rows[k]["area_x"] for k in KS]
    ok = (
        all(a < b for a, b in zip(areas, areas[1:]))      # state table grows
        and abs(rows[2]["ae_x"] - 3.14) / 3.14 <= 0.20     # paper headline
        and abs(rows[2]["ee_x"] - 3.39) / 3.39 <= 0.20
        and max(KS, key=lambda k: rows[k]["ee_x"]) == 2    # EE peaks at k=2
    )
    for k in KS:
        r = rows[k]
        report(
            name=f"fig7/k{k}",
            us_per_call=r["us"],
            derived=(
                f"area={r['area_x']:.2f}x power={r['power_x']:.2f}x "
                f"AE={r['ae_x']:.2f}x EE={r['ee_x']:.2f}x "
                + ("PASS" if ok else "MISS")
            ),
        )
