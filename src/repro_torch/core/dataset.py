"""Tuning dataset: benchmark problems, features, and the perf table.

The paper harvests GEMM shapes from VGG/ResNet/MobileNet (300 problems); we
harvest them from the assigned architectures x their input shapes (every
projection / MLP / vocab / expert GEMM the frameworks will actually launch),
via ``repro_torch.configs.registry.gemm_problems``.

A problem is ``(m, k, n, batch)``.  Classifier features are log2 sizes plus
shape-character ratios (aspect, arithmetic intensity) — cheap to compute in a
launcher, expressive enough for the shape regimes (square/skinny/deep) the
paper identifies.

Copied from ``repro/core/dataset.py``; the configs of a table are the port's
Hopper ``MatmulConfig`` instances.  The card's own table comes from
``core/gpubench.py``; :func:`build_model_dataset` is the H100 model's table
(``core/perfmodel.py``), where the reference's is its TPU model's: the
default data source of ``core/retune.incremental_retune``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..kernels.matmul import MatmulConfig, config_space

Problem = tuple[int, int, int, int]

FEATURE_NAMES = ("log2_m", "log2_k", "log2_n", "log2_batch", "log2_mn_over_k", "log2_intensity")


def problem_features(problems: list[Problem]) -> np.ndarray:
    """(n_problems, n_features) feature matrix for classifier/tree inputs.

    Fully batched — one numpy expression over the whole problem list, so the
    dispatch/tuning paths never featurize row-by-row in Python.
    """
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 4)
    if p.size == 0:
        return np.zeros((0, len(FEATURE_NAMES)))
    m, k, n, batch = p.T
    flops = 2.0 * m * k * n * batch
    bytes_min = 2.0 * (m * k + k * n + m * n) * batch
    return np.column_stack(
        [
            np.log2(m),
            np.log2(k),
            np.log2(n),
            np.log2(batch),
            np.log2((m * n) / k),
            np.log2(flops / bytes_min),
        ]
    )


@dataclasses.dataclass
class TuningDataset:
    """Raw benchmark table for one device (problems x configs, gflops/s).

    ``family`` names the kernel family the table belongs to (a key of the
    ``core.families`` registry); featurization and config parsing
    route through that family, so the same container carries matmul GEMMs,
    attention shapes, or any future op's benchmark data.
    """

    device: str
    problems: list[Problem]
    configs: list[MatmulConfig]
    perf: np.ndarray  # raw gflops/s, (n_problems, n_configs)
    source: str = "model"  # 'model' (analytic) or 'measured' (core/gpubench.py)
    family: str = "matmul"

    def __post_init__(self):
        self.perf = np.asarray(self.perf, dtype=np.float64)
        assert self.perf.shape == (len(self.problems), len(self.configs)), (
            self.perf.shape,
            len(self.problems),
            len(self.configs),
        )

    @property
    def features(self) -> np.ndarray:
        if self.family == "matmul":
            return problem_features(self.problems)
        from .families import get_family

        return get_family(self.family).features(self.problems)

    def split(self, test_fraction: float = 0.25, seed: int = 0) -> tuple["TuningDataset", "TuningDataset"]:
        rng = np.random.default_rng(seed)
        n = len(self.problems)
        order = rng.permutation(n)
        n_test = max(1, int(round(n * test_fraction)))
        test_idx = np.sort(order[:n_test])
        train_idx = np.sort(order[n_test:])
        mk = lambda idx: TuningDataset(
            device=self.device,
            problems=[self.problems[i] for i in idx],
            configs=self.configs,
            perf=self.perf[idx],
            source=self.source,
            family=self.family,
        )
        return mk(train_idx), mk(test_idx)

    # -- persistence --------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            perf=self.perf,
            problems=np.asarray(self.problems, dtype=np.int64),
            meta=json.dumps(
                {
                    "device": self.device,
                    "source": self.source,
                    "family": self.family,
                    "configs": [c.to_dict() for c in self.configs],
                }
            ),
        )

    @staticmethod
    def load(path: str | Path) -> "TuningDataset":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            family = meta.get("family", "matmul")
            if family == "matmul":
                config_cls = MatmulConfig
            else:
                from .families import get_family

                config_cls = get_family(family).config_cls
            return TuningDataset(
                device=meta["device"],
                problems=[tuple(int(v) for v in row) for row in z["problems"]],
                configs=[config_cls.from_dict(d) for d in meta["configs"]],
                perf=z["perf"],
                source=meta["source"],
                family=family,
            )


def harvest_problems(arch_ids: list[str] | None = None, *, dedup: bool = True, max_problems: int | None = None) -> list[Problem]:
    """GEMM problems from the assigned architectures (lazy configs import)."""
    from ..configs import registry

    arch_ids = arch_ids or list(registry.ARCHS)
    problems: list[Problem] = []
    seen = set()
    for arch in arch_ids:
        for shape in registry.shapes_for(arch):
            for p in registry.gemm_problems(arch, shape):
                if dedup and p in seen:
                    continue
                seen.add(p)
                problems.append(p)
    problems.sort()
    if max_problems is not None and len(problems) > max_problems:
        rng = np.random.default_rng(0)
        idx = np.sort(rng.choice(len(problems), size=max_problems, replace=False))
        problems = [problems[i] for i in idx]
    return problems


def synthetic_problems(n: int = 300, seed: int = 0) -> list[Problem]:
    """Paper-flavoured synthetic problem mix (square / rectangular / skinny)."""
    rng = np.random.default_rng(seed)
    out: list[Problem] = []
    pows = [2**e for e in range(3, 14)]
    for _ in range(n):
        kind = rng.random()
        if kind < 0.4:  # squarish
            m = int(rng.choice(pows[3:9]))
            n_ = int(rng.choice(pows[3:9]))
            k = int(rng.choice(pows[3:10]))
        elif kind < 0.7:  # rectangular, deep k
            m = int(rng.choice(pows[3:8]))
            n_ = int(rng.choice(pows[3:8]))
            k = int(rng.choice(pows[7:]))
        else:  # tall-skinny (decode-like)
            m = int(rng.choice([1, 2, 4, 8, 16, 32]))
            n_ = int(rng.choice(pows[4:10]))
            k = int(rng.choice(pows[5:11]))
        batch = int(rng.choice([1, 1, 1, 8, 16, 32]))
        out.append((m, k, n_, batch))
    return sorted(set(out))


def build_model_dataset(
    problems: list[Problem] | None = None,
    device_name: str = "gpu_nvidia_h100_80gb_hbm3",
    configs: list[MatmulConfig] | None = None,
) -> TuningDataset:
    """Dense H100-model benchmark table (``core/perfmodel.py``), ``source="model"``."""
    from .perfmodel import DEVICES, build_perf_matrix

    problems = problems if problems is not None else synthetic_problems()
    configs = list(configs if configs is not None else config_space())
    device = DEVICES[device_name]
    perf = build_perf_matrix(problems, configs, device.name)
    return TuningDataset(device=device.name, problems=problems, configs=configs, perf=perf, source="model")
