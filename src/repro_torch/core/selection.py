"""Kernel-subset selection + evaluation (paper §4.2-4.3, Figs. 5-6).

Copied verbatim from ``repro/core/selection.py`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from .cluster import CLUSTER_METHODS, select_configs
from .dataset import TuningDataset
from .normalize import NORMALIZATIONS, normalize

_EPS = 1e-12


def geomean_fraction(picked: np.ndarray, best: np.ndarray) -> float:
    """Geomean over problems of picked-perf / best-perf (the paper's headline
    fraction-of-optimal metric).

    The one shared implementation: oracle fractions (:func:`achievable_fraction`),
    shipped-classifier fractions (``dispatch.classifier_fraction``,
    ``tuner.tune_family``), and the gated family benchmarks all call this, so
    the epsilon/clipping policy cannot drift between them.  Problems where no
    config achieved positive perf count as 1.0 (nothing was achievable).
    """
    picked = np.asarray(picked, dtype=np.float64)
    best = np.asarray(best, dtype=np.float64)
    ratio = np.where(best > 0, picked / np.maximum(best, _EPS), 1.0)
    return float(np.exp(np.mean(np.log(np.maximum(ratio, _EPS)))))


def select_from_dataset(
    ds: TuningDataset,
    n_kernels: int,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    *,
    seed: int = 0,
) -> list[int]:
    """Pick the config indices to deploy, from a *training* dataset."""
    norm = normalize(ds.perf, normalization)
    return select_configs(norm, n_kernels, method, features=ds.features, seed=seed)


def achievable_fraction(perf_test: np.ndarray, chosen: list[int]) -> float:
    """Geomean over problems of best-deployed / best-overall (paper §4.3).

    This is the *oracle* fraction: assumes the launcher always picks the best
    of the deployed kernels (classifier quality is measured separately).
    """
    perf_test = np.asarray(perf_test, dtype=np.float64)
    return geomean_fraction(perf_test[:, chosen].max(axis=1), perf_test.max(axis=1))


def evaluate_methods(
    train: TuningDataset,
    test: TuningDataset,
    n_kernels_range: list[int],
    methods: list[str] | None = None,
    normalizations: list[str] | None = None,
    *,
    seed: int = 0,
) -> dict[tuple[str, str, int], float]:
    """The full Fig. 5/6 sweep: (method, normalization, n) -> oracle fraction."""
    methods = methods or list(CLUSTER_METHODS)
    normalizations = normalizations or list(NORMALIZATIONS)
    out: dict[tuple[str, str, int], float] = {}
    for norm in normalizations:
        for method in methods:
            for n in n_kernels_range:
                chosen = select_from_dataset(train, n, method, norm, seed=seed)
                out[(method, norm, n)] = achievable_fraction(test.perf, chosen)
    return out
