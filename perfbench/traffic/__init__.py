"""Traffic mixes: ``<mix>.json`` data files, each naming in ``kind`` the
generator module of this package that reads it."""
