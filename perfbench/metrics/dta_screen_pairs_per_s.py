"""Items completed per second of the window (see _rate.py)."""

from perfbench.metrics._rate import read  # noqa: F401
