"""Shape buckets, the shared vocabulary of telemetry and tuning provenance.

Copied from ``repro/core/online.py`` (``shape_bucket`` only); the online
explore-then-commit policy joins with the continuous tuning loop.
"""
from __future__ import annotations


def shape_bucket(problem: tuple[int, ...]) -> tuple[int, ...]:
    """log2 shape bucket: nearby shapes share measurements (paper's regimes).

    Shared vocabulary of the telemetry pipeline: ``core.retune`` keys its
    traffic histograms on the same buckets.
    """
    return tuple(max(int(v), 1).bit_length() for v in problem)
