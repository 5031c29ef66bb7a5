"""Area / power / energy cost models (40nm CMOS + 1T1R), paper §V.B/V.C.

We cannot tape out; instead we use a *component-calibrated analytical model*
whose coefficients are solved exactly against the paper's reported
implementation summary (Fig. 8a) and multi-bank scaling (Fig. 8b):

    anchor points (N=1024, w=32):
      baseline [18]            77.8 Kum^2   319.7 mW   32    cyc/num
      col-skip k=2, Ns=1024   101.1 Kum^2   385.2 mW    7.84 cyc/num
      col-skip k=2, Ns=64x16   86.9 Kum^2   349.3 mW    7.84 cyc/num
      merge sorter            246.1 Kum^2   825.9 mW   10    cyc/num

Component structure (per bank of Ns rows, w bit columns, k state entries):

    row processor + wordline ctl : a_r * Ns * log2(Ns)   (super-linear -> Fig 8b)
    sense amplifiers             : a_s * Ns
    column processor             : a_c * w
    state controller (k entries) : a_t * k * Ns  + a_x (skip control)
    multi-bank manager           : a_m * C

The 1T1R array itself is "orders of magnitude" smaller than the near-memory
circuit (paper §V.B) and is folded into the sense-amp term.  All coefficients
below are exact solutions of the anchor system (derivation in EXPERIMENTS.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "SorterCost",
    "colskip_cost",
    "baseline_cost",
    "merge_cost",
    "estimate_colskip_cycles",
    "fmax_mhz",
    "AREA_COEF",
    "POWER_COEF",
    "COLSKIP_SPEEDUP_ANCHOR",
]

# Paper Fig. 6/8a anchor: k=2 column skipping reaches 4.08x over the
# baseline's w cycles/number on MapReduce-like data.  This is THE a-priori
# cycle anchor — serving-policy estimates and the paper-figure benchmarks
# both read it from here so they can never disagree.
COLSKIP_SPEEDUP_ANCHOR = 4.08


def estimate_colskip_cycles(n: int, w: int = 32) -> float:
    """A-priori CR-cycle estimate for column-skip sorting ``n`` numbers."""
    return n * w / COLSKIP_SPEEDUP_ANCHOR

# --- calibrated coefficients (area: Kum^2, power: mW) -----------------------
# Exact solutions of the Fig. 8 anchor system; per-bank fixed terms chosen
# small enough that total area/power decrease monotonically down to Ns=64
# (paper: "goes down with smaller sub-sorter length", minimum at Ns=64).
AREA_COEF = dict(a_r=18.9 / 4096, a_s=30.39 / 1024, a_c=0.005, a_t=23.2 / 2048,
                 a_x=0.1, a_m=0.05)
POWER_COEF = dict(a_r=56.2 / 4096, a_s=178.56 / 1024, a_c=0.02, a_t=65.0 / 2048,
                  a_x=0.5, a_m=0.2)

MERGE_AREA_KUM2 = 246.1
MERGE_POWER_MW = 825.9
MERGE_CYCLES_PER_NUM = 10.0
BASE_CLOCK_MHZ = 500.0


def _near_memory(coef: dict, ns: int, w: int, k: int, banks: int) -> float:
    per_bank = (
        coef["a_r"] * ns * math.log2(max(2, ns))
        + coef["a_s"] * ns
        + coef["a_c"] * w
        + (coef["a_t"] * k * ns + coef["a_x"] if k > 0 else 0.0)
    )
    mgr = coef["a_m"] * banks if banks > 1 else 0.0
    return banks * per_bank + mgr


def fmax_mhz(banks: int) -> float:
    """Clock model: 500MHz holds down to Ns=64 (C=16 for N=1024); a more
    complex manager degrades fmax beyond that (paper §V.C)."""
    if banks <= 16:
        return BASE_CLOCK_MHZ
    return BASE_CLOCK_MHZ / (1.0 + 0.05 * (math.log2(banks) - 4))


@dataclass
class SorterCost:
    name: str
    area_kum2: float
    power_mw: float
    cycles_per_number: float
    clock_mhz: float = BASE_CLOCK_MHZ

    @property
    def throughput_num_per_s(self) -> float:
        return self.clock_mhz * 1e6 / self.cycles_per_number

    @property
    def area_eff(self) -> float:
        """Num/ns/mm^2 (paper Fig. 8a)."""
        return (self.throughput_num_per_s * 1e-9) / (self.area_kum2 * 1e-3)

    @property
    def energy_eff(self) -> float:
        """Num/uJ (paper Fig. 8a)."""
        return self.throughput_num_per_s / (self.power_mw * 1e-3) / 1e6


def baseline_cost(n: int = 1024, w: int = 32) -> SorterCost:
    return SorterCost(
        name="baseline18",
        area_kum2=_near_memory(AREA_COEF, n, w, k=0, banks=1),
        power_mw=_near_memory(POWER_COEF, n, w, k=0, banks=1),
        cycles_per_number=float(w),
    )


def colskip_cost(
    cycles_per_number: float, n: int = 1024, w: int = 32, k: int = 2, banks: int = 1
) -> SorterCost:
    ns = n // banks
    return SorterCost(
        name=f"colskip-k{k}" + (f"-Ns{ns}" if banks > 1 else ""),
        area_kum2=_near_memory(AREA_COEF, ns, w, k, banks),
        power_mw=_near_memory(POWER_COEF, ns, w, k, banks),
        cycles_per_number=cycles_per_number,
        clock_mhz=fmax_mhz(banks),
    )


def merge_cost(n: int = 1024, w: int = 32) -> SorterCost:
    return SorterCost(
        name="merge",
        area_kum2=MERGE_AREA_KUM2,
        power_mw=MERGE_POWER_MW,
        cycles_per_number=MERGE_CYCLES_PER_NUM,
    )
