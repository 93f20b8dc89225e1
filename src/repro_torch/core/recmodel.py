"""The recurrence families' problem spaces: WKV and selective-scan features.

Copied from ``repro/core/recmodel.py`` (the feature names and
featurizations only).  The problem of the WKV family is ``(s, hd)``
(sequence length x head dim), that of the selective scan ``(s, d)``
(sequence length x inner width).  The reference's analytic TPU models and
harvests stay behind; the families' harvests and measured tables join with
their tuning.
"""
from __future__ import annotations

import numpy as np

WkvProblem = tuple[int, int]  # (seq_len, head_dim)
SsmProblem = tuple[int, int]  # (seq_len, d_inner)

WKV_FEATURE_NAMES = ("log2_s", "log2_hd", "log2_s_over_hd")
SSM_FEATURE_NAMES = ("log2_s", "log2_d", "log2_s_over_d")


def _log2_features(p: np.ndarray) -> np.ndarray:
    a, b = p.T
    return np.column_stack([np.log2(a), np.log2(b), np.log2(a / b)])


def wkv_problem_features(problems: list[WkvProblem]) -> np.ndarray:
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 2)
    if p.size == 0:
        return np.zeros((0, len(WKV_FEATURE_NAMES)))
    return _log2_features(np.maximum(p, 1.0))


def ssm_problem_features(problems: list[SsmProblem]) -> np.ndarray:
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 2)
    if p.size == 0:
        return np.zeros((0, len(SSM_FEATURE_NAMES)))
    return _log2_features(np.maximum(p, 1.0))
