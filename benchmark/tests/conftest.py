"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository (the ``cuda`` tests skip without a card and run on
the chip: ``python -m pytest -m cuda benchmark/tests``)."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))
