"""The benchmark of ``repro_torch``, the PyTorch and CUDA sort service.

Run a cell: ``python perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.
"""
