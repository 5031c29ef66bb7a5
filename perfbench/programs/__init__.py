"""The programs a configuration can name under its key ``program``: one
module a program, found by name (see :mod:`perfbench.harness`)."""
