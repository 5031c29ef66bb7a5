"""Paper Fig. 6 — normalized speedup over baseline [18] per dataset vs k.

Reports speedup = 32 / (colskip cycles/number) for N=1024, w=32, k=1..4, and
checks the reproduction bands:
  * best-k speedups per dataset within 20% of the paper's reported values,
  * saturation: best k in {2, 3} on every dataset (paper §V.A).

A copy of the reference's ``benchmarks/fig6_speedup.py`` on
:mod:`repro_torch.core` (numpy on the host; ``device`` is unused).
"""

from __future__ import annotations

from .paper_common import DATASETS, KS, PAPER_BEST_SPEEDUP, W, colskip_cycles_per_num, timed


def run(report, device="cuda"):
    for ds in DATASETS:
        speeds = {}
        us_total = 0.0
        for k in KS:
            cyc, us = timed(colskip_cycles_per_num, ds, k)
            speeds[k] = W / cyc
            us_total += us
        best_k = max(speeds, key=speeds.get)
        best = speeds[best_k]
        target = PAPER_BEST_SPEEDUP[ds]
        ok = abs(best - target) / target <= 0.20 and best_k in (2, 3)
        report(
            name=f"fig6/{ds}",
            us_per_call=us_total / len(KS),
            derived=(
                f"speedup_k1..4={'/'.join(f'{speeds[k]:.2f}' for k in KS)}"
                f" best={best:.2f}@k={best_k} paper={target:.2f} "
                + ("PASS" if ok else "MISS")
            ),
        )
