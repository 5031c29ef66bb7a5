"""Roofline terms of one NVIDIA H100 SXM5 80GB — the port of
``repro/launch/roofline.py``, whose peaks are a TPU v5e's.

    compute term    = FLOPs / 989e12 FLOP/s        (dense bf16 tensor cores)
    memory term     = HBM bytes / 3.35e12 B/s      (HBM3)
    collective term = collective bytes / 900e9 B/s (NVLink 4)

Each figure is NVIDIA's H100 SXM5 80GB datasheet's, without sparsity, at
the card's 700 W power limit; a card set below it runs slower.  The
reference's ``collective_bytes(hlo_text)`` parses XLA's optimized HLO for
collective ops, which the port never has (no compiler partitions its
steps); ``launch/dryrun.py`` counts them as a model of a runtime that
follows ``dist/sharding``'s specs instead.  :func:`roofline_terms` takes
collective bytes as given, and ``None`` leaves the collective term out of
the bottleneck.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card (datasheet)
HBM_BW = 3.35e12             # B/s per card, HBM3 (datasheet)
NVLINK_BW = 900e9            # B/s per card, NVLink 4, 18 links (datasheet)


@dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float             # per device
    coll_bytes: float | None     # per device; None: not known
    t_compute: float
    t_memory: float
    t_collective: float | None
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def as_dict(self):
        return asdict(self)


def roofline_terms(flops: float, hbm_bytes: float, n_devices: int,
                   coll_bytes: float | None = None,
                   model_flops: float = 0.0) -> Roofline:
    """The terms of per-device ``flops`` and ``hbm_bytes`` (and
    ``coll_bytes`` when known); ``model_flops`` is the whole step's."""
    t_c = flops / PEAK_FLOPS
    t_m = hbm_bytes / HBM_BW
    t_x = None if coll_bytes is None else coll_bytes / NVLINK_BW
    terms = {"compute": t_c, "memory": t_m}
    if t_x is not None:
        terms["collective"] = t_x
    bott = max(terms, key=terms.get)
    useful = model_flops / (flops * n_devices) if flops else 0.0
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes,
                    t_compute=t_c, t_memory=t_m, t_collective=t_x,
                    bottleneck=bott, model_flops=model_flops,
                    useful_ratio=useful)
