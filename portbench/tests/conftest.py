"""Test-size files of the configurations added after ``helpers.TINY``:
each configuration of ``BENCHMARK.json`` runs here under its name from a
file of ``data/``."""

from portbench.tests import helpers

helpers.TINY.setdefault("granite-4.0-h-small", "granite-hybrid-tiny")
