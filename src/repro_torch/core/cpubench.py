"""Measured host-CPU benchmark source (the paper's i7-6700K analogue).

Copied from ``repro/core/cpubench.py``: the paper's second device is a CPU;
ours is the host.  A *cache-blocked* numpy GEMM is timed under each
``MatmulConfig(block_m, block_n, block_k, order)`` of the port's compiled
space (blocks play the role of L1/L2 tiles instead of shared-memory tiles),
giving a measured ``host_cpu`` table with its own optima per shape.  It is
numpy, as in the reference: it times no torch kernel and is no fallback for
the card; ``tuner.tune_fleet`` tunes the fleet's ``host_cpu`` entry from it.
"""
from __future__ import annotations

import time

import numpy as np

from ..kernels.matmul import MatmulConfig, config_space

from .dataset import Problem, TuningDataset


def blocked_gemm(a: np.ndarray, b: np.ndarray, cfg: MatmulConfig) -> np.ndarray:
    """Cache-blocked matmul with the config's tiling + loop order (numpy's
    ``np.dot`` on each block, the reference's ``@``)."""
    m, k = a.shape
    _, n = b.shape
    out = np.zeros((m, n), dtype=np.float32)
    bm, bn, bk = min(cfg.block_m, m), min(cfg.block_n, n), min(cfg.block_k, k)
    m_blocks = range(0, m, bm)
    n_blocks = range(0, n, bn)
    if cfg.order == "mnk":
        for i in m_blocks:
            for j in n_blocks:
                acc = out[i : i + bm, j : j + bn]
                for s in range(0, k, bk):
                    acc += np.dot(a[i : i + bm, s : s + bk], b[s : s + bk, j : j + bn])
    else:
        for j in n_blocks:
            for i in m_blocks:
                acc = out[i : i + bm, j : j + bn]
                for s in range(0, k, bk):
                    acc += np.dot(a[i : i + bm, s : s + bk], b[s : s + bk, j : j + bn])
    return out


def _time_config(a, b, cfg, *, min_time: float = 0.02, max_reps: int = 5) -> float:
    """Median wall-time of blocked_gemm; adaptively repeats short runs."""
    times = []
    t_total = 0.0
    for _ in range(max_reps):
        t0 = time.perf_counter()
        blocked_gemm(a, b, cfg)
        dt = time.perf_counter() - t0
        times.append(dt)
        t_total += dt
        if t_total > min_time and len(times) >= 2:
            break
    return float(np.median(times))


def cpu_problems(n: int = 24, seed: int = 0) -> list[Problem]:
    """Paper-flavoured shapes scaled to CPU-friendly sizes (batch folded in)."""
    rng = np.random.default_rng(seed)
    out = set()
    pows = [64, 128, 192, 256, 384, 512]
    while len(out) < n:
        kind = rng.random()
        if kind < 0.45:  # squarish
            m, k_, n_ = rng.choice(pows, 3)
        elif kind < 0.75:  # deep-k rectangular
            m, n_ = rng.choice(pows[:4], 2)
            k_ = int(rng.choice([512, 768, 1024]))
        else:  # tall-skinny
            m = int(rng.choice([1, 4, 8, 16]))
            k_ = int(rng.choice([256, 512, 1024]))
            n_ = int(rng.choice(pows[2:]))
        out.add((int(m), int(k_), int(n_), 1))
    return sorted(out)


def build_cpu_dataset(
    problems: list[Problem] | None = None,
    configs: list[MatmulConfig] | None = None,
    *,
    verbose: bool = False,
) -> TuningDataset:
    """Measure the full (problems x configs) wall-clock table on this host."""
    problems = problems if problems is not None else cpu_problems()
    configs = list(configs if configs is not None else config_space())
    perf = np.zeros((len(problems), len(configs)))
    rng = np.random.default_rng(0)
    for i, (m, k, n, batch) in enumerate(problems):
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
        flops = 2.0 * m * k * n * batch
        for j, cfg in enumerate(configs):
            t = _time_config(a, b, cfg)
            perf[i, j] = flops / t / 1e9  # measured gflops/s
        if verbose:
            print(f"  measured problem {i + 1}/{len(problems)}: {problems[i]}", flush=True)
    return TuningDataset(
        device="host_cpu", problems=problems, configs=configs, perf=perf, source="measured"
    )
