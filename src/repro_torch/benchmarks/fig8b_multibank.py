"""Paper Fig. 8(b) — multi-bank area/power vs sub-sorter length Ns.

Builds N=1024, k=2 column-skipping sorters from sub-sorters of length
Ns in {64, 256, 512, 1024}; verifies (a) the multi-bank sorter's cycle count
is IDENTICAL to the monolithic one (paper: "does not change the speedup"),
(b) area/power decrease monotonically with Ns, and (c) at Ns=64 the
reduction is ~14% area / ~9% power (paper's reported maxima).

A copy of the reference's ``benchmarks/fig8b_multibank.py`` on
:mod:`repro_torch.core` (numpy on the host; ``device`` is unused).
"""

from __future__ import annotations

import numpy as np

from .paper_common import N, W, timed
from repro_torch.core.colskip import colskip_sort
from repro_torch.core.costmodel import colskip_cost
from repro_torch.core.datasets import make_dataset
from repro_torch.core.multibank import multibank_colskip_sort


def run(report, device="cuda"):
    v = make_dataset("mapreduce", N, W, seed=3)
    mono = colskip_sort(v, W, 2)
    ref = colskip_cost(mono.cycles_per_number, k=2, banks=1)
    for ns in [512, 256, 64]:
        banks = N // ns
        mb, us = timed(multibank_colskip_sort, v, W, 2, banks)
        assert mb.cycles == mono.cycles, "multi-bank changed the cycle count"
        assert np.array_equal(mb.values, mono.values)
        c = colskip_cost(mb.cycles_per_number, k=2, banks=banks)
        area_x = c.area_kum2 / ref.area_kum2
        pow_x = c.power_mw / ref.power_mw
        ok = True
        if ns == 64:
            ok = abs((1 - area_x) - 0.14) <= 0.02 and abs((1 - pow_x) - 0.09) <= 0.02
        report(
            name=f"fig8b/Ns{ns}",
            us_per_call=us,
            derived=(
                f"banks={banks} cyc={c.cycles_per_number:.2f} "
                f"area={area_x:.3f}x power={pow_x:.3f}x fmax={c.clock_mhz:.0f}MHz "
                + ("PASS" if ok else "MISS")
            ),
        )
