"""End-to-end auto-tuning pipeline (the paper, as one function), on the card.

``tune()`` = benchmark table -> normalize -> cluster-select the deployable
kernel subset -> train the runtime classifier -> emit the
:class:`~repro_torch.core.dispatch.Deployment` artifact that
``kernels.ops`` consumes through a ``KernelRuntime``.  Fully automated:
given benchmark data for a device, no developer effort is needed (paper
abstract).

Ported from ``repro/core/tuner.py``.  :func:`tune_for_archs` is the entry
point a user calls on the card: it harvests the GEMM problems the
architectures launch, measures the matmul table with the port's own kernel
(``core/gpubench.py``, where the reference uses its TPU analytic model), and
runs :func:`tune` on it, which measures and tunes every requested family the
same way (default ``["attention"]``).
The staged pipeline's knobs, ``tune_fleet`` and ``save_fleet`` join with
their slices.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from .dataset import TuningDataset, harvest_problems
from .dispatch import Deployment
from .families import KernelFamily, get_family


@dataclasses.dataclass
class TuneResult:
    deployment: Deployment
    chosen: list[int]
    oracle_fraction: float  # best-achievable with the deployed subset
    classifier_fraction: float  # what the shipped classifier actually attains
    train: TuningDataset
    test: TuningDataset
    family_results: dict[str, "FamilyTuneResult"] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FamilyTuneResult:
    """One non-matmul family through the pipeline.

    ``lineage`` is the pipeline's cost record (cells measured, seconds).
    """

    family: str
    configs: list
    tree: object
    problems: list[tuple]
    oracle_fraction: float
    classifier_fraction: float
    lineage: dict | None = None


def tune_family(
    name: str | KernelFamily,
    arch_ids: list[str] | None = None,
    *,
    n_kernels: int | None = None,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    seed: int = 0,
    device_name: str | None = None,
    problems: list[tuple] | None = None,
) -> FamilyTuneResult:
    """Measure + select + classify one registered kernel family.

    ``problems`` overrides the family's harvest.  Implemented as
    ``pipeline.run_family_pipeline``.
    """
    fam = name if isinstance(name, KernelFamily) else get_family(name)
    if fam.name == "matmul":
        raise ValueError("the matmul family is tuned via tune()/tune_for_archs")
    from .pipeline import run_family_pipeline

    return run_family_pipeline(
        fam,
        arch_ids,
        problems=problems,
        device_name=device_name,
        n_kernels=n_kernels,
        method=method,
        normalization=normalization,
        seed=seed,
    ).to_family_result()


def tune(
    dataset: TuningDataset,
    *,
    n_kernels: int = 8,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    classifier: str = "DecisionTreeA",
    test_fraction: float = 0.25,
    seed: int = 0,
    arch_ids: list[str] | None = None,
    n_attn_kernels: int = 4,
    families: list[str] | None = None,
) -> TuneResult:
    """Run the full paper pipeline on a matmul benchmark dataset, then on
    every requested family.

    ``arch_ids`` scopes every non-matmul family's problem harvest (None =
    all registered architectures); a family none of those archs launch is
    skipped and serves its default.  ``families`` selects the non-matmul
    families to tune (default ``["attention"]``: those with a measured H100
    source; ``wkv`` and ``ssm_scan`` raise).  Implemented by
    ``pipeline.tune_dataset``.
    """
    from .pipeline import tune_dataset

    return tune_dataset(
        dataset,
        n_kernels=n_kernels,
        method=method,
        normalization=normalization,
        classifier=classifier,
        test_fraction=test_fraction,
        seed=seed,
        arch_ids=arch_ids,
        n_attn_kernels=n_attn_kernels,
        families=families,
    )


DEFAULT_MAX_PROBLEMS = 300  # the cap on the GEMM problems: the reference CLI's default


def tune_for_archs(
    arch_ids: list[str] | None = None,
    *,
    n_kernels: int = 8,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    classifier: str = "DecisionTreeA",
    max_problems: int | None = DEFAULT_MAX_PROBLEMS,
    seed: int = 0,
    families: list[str] | None = None,
) -> TuneResult:
    """Tune on the card against the GEMM shapes the architectures launch.

    The matmul table is measured with ``matmul_cuda`` on the current CUDA
    device, over ``harvest_problems(arch_ids, max_problems=...)`` (the
    reference's seeded subsample above ``max_problems``), then :func:`tune`
    runs on it; every requested family is measured the same way.  Raises
    with no card.
    """
    from .gpubench import build_gpu_dataset, card_name

    card_name()  # no card: raise before harvesting anything
    problems = harvest_problems(arch_ids, max_problems=max_problems)
    ds, seconds = build_gpu_dataset("matmul", problems)
    result = tune(
        ds,
        n_kernels=n_kernels,
        method=method,
        normalization=normalization,
        classifier=classifier,
        seed=seed,
        arch_ids=arch_ids,
        families=families,
    )
    meta = result.deployment.meta
    meta["tuning_lineage"]["matmul"]["measure_seconds"] = round(seconds, 3)
    meta.update(
        archs=list(arch_ids) if arch_ids else "all",
        max_problems=max_problems,
        tables={"matmul": [len(ds.problems), len(ds.configs)]} | {
            name: [len(r.problems), len(get_family(name).config_space())]
            for name, r in result.family_results.items()
        },
    )
    return result


def save_result(result: TuneResult, path: str | Path) -> None:
    result.deployment.meta.update(
        oracle_fraction=result.oracle_fraction,
        classifier_fraction=result.classifier_fraction,
    )
    result.deployment.save(path)
