"""Performance-data normalization schemes (paper §3.4, Fig. 4).

Each scheme maps a vector of raw per-config performances (gigaflops/s, higher
is better) for ONE problem instance to values in [0, 1], with the best
performing kernels near 1.  Rows of zeros (e.g. a problem where every config
failed) normalize to zeros.

Schemes (names follow the paper):
  * ``standard``    — divide by the per-problem max ("standard scaled").
  * ``raw_cutoff``  — like standard, but values < cutoff clamped to 0 (values
                      keep their raw scale, giving sparsity without rescaling).
  * ``cutoff``      — raw_cutoff then rescaled so surviving values span [0,1]
                      ("standard cutoff").
  * ``sigmoid``     — f(x) = 1 / (1 + exp(50 * (0.85 - x))) applied to the
                      standard-scaled values: 85 % of peak -> 0.5, <80 % -> <0.1.

Copied verbatim from ``repro/core/normalize.py`` (numpy only).
"""
from __future__ import annotations

import numpy as np

NORMALIZATIONS = ("standard", "raw_cutoff", "cutoff", "sigmoid")

_DEFAULT_CUTOFF = 0.9


def _scale_rows(perf: np.ndarray) -> np.ndarray:
    perf = np.asarray(perf, dtype=np.float64)
    mx = perf.max(axis=-1, keepdims=True)
    safe = np.where(mx > 0, mx, 1.0)
    return np.where(mx > 0, perf / safe, 0.0)


def normalize(perf: np.ndarray, method: str = "standard", cutoff: float = _DEFAULT_CUTOFF) -> np.ndarray:
    """Normalize raw performance rows; ``perf`` is (n_problems, n_configs) or 1-D."""
    scaled = _scale_rows(perf)
    if method == "standard":
        return scaled
    if method == "raw_cutoff":
        return np.where(scaled >= cutoff, scaled, 0.0)
    if method == "cutoff":
        clipped = np.where(scaled >= cutoff, scaled, 0.0)
        # Rescale surviving values from [cutoff, 1] to [0, 1] per row.
        out = np.where(clipped > 0, (clipped - cutoff) / (1.0 - cutoff), 0.0)
        return out
    if method == "sigmoid":
        sig = 1.0 / (1.0 + np.exp(50.0 * (0.85 - scaled)))
        # Keep exact zeros (failed configs) at zero.
        return np.where(scaled > 0, sig, 0.0)
    raise ValueError(f"unknown normalization {method!r}; expected one of {NORMALIZATIONS}")
