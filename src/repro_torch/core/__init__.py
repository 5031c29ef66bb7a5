"""Core: the packed bit substrate, the sortable-uint32 top-k engine, and
framework-free copies of the reference's hardware models and cost model.

Unlike the reference's ``core/__init__``, nothing is imported eagerly
here: the numpy models stay importable without touching torch kernels.
"""
