"""Paper Fig. 8(a) — implementation summary table.

Reproduces the four-row summary (baseline / merge / col-skip k=2 / col-skip
k=2 Ns=64) with cycles/number from the simulator and area/power from the
calibrated model.  Checks the headline claims: >=3x area efficiency and
>=3x energy efficiency over the baseline at k=2, and the paper's absolute
numbers within tolerance (cycles within 10%, area/power anchors exact).

A copy of the reference's ``benchmarks/fig8a_summary.py`` on
:mod:`repro_torch.core` (numpy on the host; ``device`` is unused).
"""

from __future__ import annotations

from .paper_common import PAPER_K2_MAPREDUCE_CYC, colskip_cycles_per_num, timed
from repro_torch.core.costmodel import baseline_cost, colskip_cost, merge_cost

PAPER_ROWS = {
    "baseline": (32.0, 77.8, 319.7, 0.20, 48.9),
    "merge": (10.0, 246.1, 825.9, 0.20, 60.5),
    "colskip_k2": (7.84, 101.1, 385.2, 0.63, 165.6),
    "colskip_k2_Ns64": (7.84, 86.9, 349.3, 0.73, 182.6),
}


def run(report, device="cuda"):
    cyc, us = timed(colskip_cycles_per_num, "mapreduce", 2)
    rows = {
        "baseline": baseline_cost(),
        "merge": merge_cost(),
        "colskip_k2": colskip_cost(cyc, k=2, banks=1),
        "colskip_k2_Ns64": colskip_cost(cyc, k=2, banks=16),
    }
    base = rows["baseline"]
    for name, c in rows.items():
        p_cyc, p_area, p_pow, p_ae, p_ee = PAPER_ROWS[name]
        cyc_ok = abs(c.cycles_per_number - p_cyc) / p_cyc <= 0.10
        area_ok = abs(c.area_kum2 - p_area) / p_area <= 0.02
        pow_ok = abs(c.power_mw - p_pow) / p_pow <= 0.02
        report(
            name=f"fig8a/{name}",
            us_per_call=us if name.startswith("colskip") else 0.0,
            derived=(
                f"cyc={c.cycles_per_number:.2f} area={c.area_kum2:.1f}K "
                f"pow={c.power_mw:.1f}mW AE={c.area_eff:.2f} EE={c.energy_eff:.1f} "
                f"AEx={c.area_eff / base.area_eff:.2f} EEx={c.energy_eff / base.energy_eff:.2f} "
                + ("PASS" if cyc_ok and area_ok and pow_ok else "MISS")
            ),
        )
