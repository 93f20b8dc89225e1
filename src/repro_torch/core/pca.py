"""Principal component analysis, from scratch (paper §3.3, Fig. 3).

SVD-based PCA used both to (a) estimate how many deployed kernels are needed
(variance concentration, Fig. 3) and (b) as a pre-transform for k-means
clustering (paper §4.1.2).

Copied from ``repro/core/pca.py`` (numpy only); each ``a @ b`` is spelled
``np.matmul(a, b)``, the same operation, because the port keeps ``@`` to its
plain tensor versions (``kernels/ref.py``).
"""
from __future__ import annotations

import numpy as np


class PCA:
    """Mean-centred SVD PCA.

    Parameters
    ----------
    n_components:
        Number of principal components to keep. ``None`` keeps all.
    """

    def __init__(self, n_components: int | None = None):
        self.n_components = n_components
        self.mean_: np.ndarray | None = None
        self.components_: np.ndarray | None = None  # (k, n_features)
        self.explained_variance_: np.ndarray | None = None
        self.explained_variance_ratio_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "PCA":
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"PCA expects 2-D data, got shape {x.shape}")
        n, _ = x.shape
        self.mean_ = x.mean(axis=0)
        xc = x - self.mean_
        # Economy SVD: xc = U S Vt, principal axes are rows of Vt.
        _, s, vt = np.linalg.svd(xc, full_matrices=False)
        var = (s**2) / max(n - 1, 1)
        total = var.sum()
        ratio = var / total if total > 0 else np.zeros_like(var)
        k = self.n_components or len(s)
        k = min(k, len(s))
        self.components_ = vt[:k]
        self.explained_variance_ = var[:k]
        self.explained_variance_ratio_ = ratio[:k]
        self._full_ratio = ratio
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.components_ is None:
            raise RuntimeError("PCA.transform called before fit")
        x = np.asarray(x, dtype=np.float64)
        return np.matmul(x - self.mean_, self.components_.T)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, z: np.ndarray) -> np.ndarray:
        if self.components_ is None:
            raise RuntimeError("PCA.inverse_transform called before fit")
        return np.matmul(np.asarray(z), self.components_) + self.mean_

    def n_components_for_variance(self, fraction: float) -> int:
        """Smallest number of components whose cumulative variance >= fraction."""
        if self.components_ is None:
            raise RuntimeError("fit first")
        cum = np.cumsum(self._full_ratio)
        return int(np.searchsorted(cum, fraction) + 1)
