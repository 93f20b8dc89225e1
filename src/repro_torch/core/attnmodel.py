"""The attention family's problem space: features and the harvest.

Copied from ``repro/core/attnmodel.py``: the problem is ``(sq, skv, d)``
(query rows, key/value rows, head dim) and the config ``AttentionConfig(
block_q, block_kv)``.  The reference's analytic TPU v5e model
(``predict_attn_time`` and ``build_attn_matrix``) stays behind: the port's
attention table is measured on the card (``core/gpubench.py``).
"""
from __future__ import annotations

import numpy as np

AttnProblem = tuple[int, int, int]  # (sq, skv, head_dim)

ATTN_FEATURE_NAMES = ("log2_sq", "log2_skv", "log2_d", "log2_sq_over_skv")


def attn_problem_features(problems: list[AttnProblem]) -> np.ndarray:
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 3)
    if p.size == 0:
        return np.zeros((0, len(ATTN_FEATURE_NAMES)))
    sq, skv, d = p.T
    return np.column_stack([np.log2(sq), np.log2(skv), np.log2(d), np.log2(sq / skv)])


def harvest_attn_problems(arch_ids: list[str] | None = None) -> list[AttnProblem]:
    """Attention shapes the assigned architectures actually launch."""
    from ..configs import registry

    arch_ids = arch_ids or list(registry.ARCHS)
    out: set[AttnProblem] = set()
    for arch in arch_ids:
        cfg = registry.get(arch)
        if cfg.family == "ssm":
            continue  # attention-free (DESIGN.md §4)
        hd = cfg.head_dim
        for shape in registry.shapes_for(arch):
            sp = registry.SHAPES[shape]
            if sp.kind == "decode":
                out.add((1, sp.seq_len, hd))
            else:
                out.add((sp.seq_len, sp.seq_len, hd))
                # chunked-prefill style sub-blocks
                out.add((min(2048, sp.seq_len), sp.seq_len, hd))
    return sorted(out)
