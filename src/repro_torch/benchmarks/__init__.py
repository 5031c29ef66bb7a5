"""Benchmark harness of the port, the twin of the reference's
``benchmarks/``: one module per paper figure plus the kernel and serving
suites.  Run ``python -m repro_torch.benchmarks.run``."""
