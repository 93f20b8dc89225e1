"""Training-distribution provenance of a tuned artifact.

Copied from ``repro/core/retune.py`` (``bucket_key`` and
``train_distribution`` only): ``pipeline.tune_dataset`` stamps the shape
distribution a ``Deployment`` was tuned against into its ``meta``, so that a
serving host can later tell when live traffic drifts away from it.
Telemetry, drift detection and the incremental retune join with the
continuous tuning loop.
"""
from __future__ import annotations

import numpy as np

from .online import shape_bucket

Bucket = tuple[int, ...]


def bucket_key(bucket: Bucket) -> str:
    """JSON-safe bucket key: ``(9, 10, 9, 1)`` -> ``"9,10,9,1"``."""
    return ",".join(str(int(v)) for v in bucket)


def train_distribution(
    problems: list[tuple], weights: np.ndarray | None = None
) -> dict:
    """Provenance blob describing a tuning dataset's shape distribution.

    JSON-ready (it rides inside ``Deployment.meta``):

        {"buckets": {"9,10,9,1": {"w": 0.25, "problem": [512, 784, 512, 16]},
                     ...},
         "n_problems": 60}

    ``w`` is the bucket's share of (optionally weighted) problems; ``problem``
    is one representative shape per bucket, kept so an incremental retune can
    rebuild benchmark rows for undrifted buckets without the full dataset.
    """
    w = np.ones(len(problems)) if weights is None else np.asarray(weights, float)
    buckets: dict[str, dict] = {}
    total = float(w.sum()) or 1.0
    for p, wi in zip(problems, w):
        key = bucket_key(shape_bucket(p))
        ent = buckets.setdefault(key, {"w": 0.0, "problem": [int(v) for v in p]})
        ent["w"] += float(wi) / total
    return {"buckets": buckets, "n_problems": len(problems)}
