"""Hand-written CUDA kernels for Hopper, one package per Pallas kernel of
the reference: ``csrc/*.cu`` (the kernel), ``ops.py`` (the wrapper that
launches it on CUDA tensors) and ``ref.py`` (the plain torch version the
wrapper takes for CPU tensors)."""
