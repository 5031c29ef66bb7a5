"""PyTorch/CUDA port of the column-skipping in-memory sorting stack.

A second package beside the JAX reference :mod:`repro`, mirroring its
layout path for path: each module here is held against the module at the
same relative path there.  The Pallas kernels of the reference become
CUDA C++ kernels for Hopper (``kernels/*/csrc/*.cu``), built at first use
by :mod:`repro_torch.kernels._build` and bound with ``ctypes``; a plain
torch version sits beside each kernel in its ``ref.py``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
with no card they raise (:func:`repro_torch._device.resolve_device`).
The package imports torch and numpy only — never jax, never ``repro``.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
