"""Device selection for the port's entry points.

Every entry point defaults to ``"cuda"``.  There is no fallback: asking
for the card where none exists raises, and only an explicit ``"cpu"``
runs the plain torch versions on the host (what the CPU tests do).
``"meta"`` builds a model's shapes with no storage, for the sharding
rules (``dist/sharding.py``); nothing runs there.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked
    for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain torch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
