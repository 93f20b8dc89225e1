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
runs :func:`tune` on it, which measures and tunes every requested family
the same way (default: every registered family).  The staged pipeline's
knobs (``prune_ratio``, ``measure_budget``, ``transfer_from``) pass through
:func:`tune_family` and :func:`tune_for_archs` to ``core/pipeline.py``.

:func:`tune_fleet` tunes several devices into one
:class:`~repro_torch.core.bundle.DeploymentBundle`.  Three differences from
the reference, all by design: every family of the port is
device-sensitive (its table is the card's own), so nothing is shared
across the fleet and no family tuning is passed between devices;
``host_cpu`` gets the measured numpy matmul tuning of ``core/cpubench.py``
and answers every other family's default (on the CPU the port runs the
kernels' plain versions, which take no config, so no output depends on
it), where the reference gives it the fleet's shared family tunings; and a
fleet holds at most one card, this host's (another card's tables cannot be
measured here), so there is no card-to-card transfer (the reference's
``transfer=True``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from .dataset import TuningDataset, harvest_problems
from .dispatch import Deployment
from .families import KernelFamily, family_names, get_family


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

    ``lineage`` is the staged pipeline's cost record (source device, prune
    ratio, measured fraction, model error); ``measure_seconds`` the wall
    time its measurement took; ``perf`` the table it was tuned on (its
    columns the kept configs, ``kept``, indices into the config space).
    """

    family: str
    configs: list
    tree: object
    problems: list[tuple]
    oracle_fraction: float
    classifier_fraction: float
    lineage: dict | None = None
    measure_seconds: float | None = None
    perf: object = None  # the (problems x kept configs) table, measured and model-filled
    kept: tuple[int, ...] | None = None


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
    prune_ratio: float | None = None,
    measure_budget: float | str | None = None,
    transfer_from=None,
) -> FamilyTuneResult:
    """Measure + select + classify one registered kernel family.

    ``problems`` overrides the family's harvest.  Implemented as
    ``pipeline.run_family_pipeline``; ``prune_ratio`` / ``measure_budget`` /
    ``transfer_from`` are its stage knobs (defaults: every cell measured).
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
        prune_ratio=prune_ratio,
        measure_budget=measure_budget,
        transfer_from=transfer_from,
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
    families to tune (default: every registered one, each measured on the
    card).  Implemented by ``pipeline.tune_dataset``.
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
    device_name: str | None = None,
    n_kernels: int = 8,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    classifier: str = "DecisionTreeA",
    max_problems: int | None = DEFAULT_MAX_PROBLEMS,
    seed: int = 0,
    families: list[str] | None = None,
    transfer_from=None,
    prune_ratio: float | None = None,
    measure_budget: float | str | None = None,
) -> TuneResult:
    """Tune on the card against the GEMM shapes the architectures launch.

    The matmul table is measured with ``matmul_cuda`` on the current CUDA
    device, over ``harvest_problems(arch_ids, max_problems=...)`` (the
    reference's seeded subsample above ``max_problems``), then :func:`tune`
    runs on it; every requested family is measured the same way.
    ``device_name`` must name this card (default: it).  Raises with no card.

    With any staged-pipeline knob set (``transfer_from``: anything
    ``pipeline.as_transfer_prior`` accepts, e.g. an earlier ``Deployment`` of
    this card; ``prune_ratio``; ``measure_budget``) the matmul table comes
    from ``pipeline.staged_matmul_dataset``: pruned on the H100 model,
    measured only where the model and the donor disagree (within the
    budget), model-filled elsewhere; every family takes the same knobs.
    ``measure_budget="auto"`` sizes each family's budget from the donor's
    recorded ``tuning_lineage[family].model_error``; with no donor it
    measures in full.  The seconds each table took are stamped into
    ``meta["measure_seconds"]``.
    """
    import time

    from .gpubench import build_gpu_dataset, card_name
    from .pipeline import resolve_measure_budget, staged_matmul_dataset, tune_dataset

    card = card_name()  # no card: raise before harvesting anything
    if device_name is not None and device_name != card:
        raise ValueError(f"tables are measured on this card ({card}), not on {device_name!r}")
    matmul_budget = resolve_measure_budget(measure_budget, transfer_from)
    problems = harvest_problems(arch_ids, max_problems=max_problems)
    staged = (
        transfer_from is not None
        or (prune_ratio is not None and 0.0 < prune_ratio < 1.0)
        or (matmul_budget is not None and 0.0 < matmul_budget < 1.0)
    )
    lineage = None
    t0 = time.perf_counter()
    if staged:
        ds, matmul_lineage, _donor = staged_matmul_dataset(
            problems, card, prune_ratio=prune_ratio, measure_budget=matmul_budget,
            transfer_from=transfer_from,
        )
        lineage = {"matmul": matmul_lineage}
        seconds = time.perf_counter() - t0
    else:
        ds, seconds = build_gpu_dataset("matmul", problems)
    result = tune_dataset(
        ds,
        n_kernels=n_kernels,
        method=method,
        normalization=normalization,
        classifier=classifier,
        seed=seed,
        arch_ids=arch_ids,
        families=families,
        transfer_from=transfer_from,
        prune_ratio=prune_ratio,
        measure_budget=measure_budget,
        lineage=lineage,
    )
    meta = result.deployment.meta
    space = len(get_family("matmul").config_space())
    meta.update(
        archs=list(arch_ids) if arch_ids else "all",
        max_problems=max_problems,
        tables={"matmul": [len(ds.problems), space]} | {
            name: [len(r.problems), len(get_family(name).config_space())]
            for name, r in result.family_results.items()
        },
        measure_seconds={"matmul": round(seconds, 3)} | {
            name: round(r.measure_seconds, 3) for name, r in result.family_results.items()
            if r.measure_seconds is not None
        },
    )
    return result


def save_result(result: TuneResult, path: str | Path) -> None:
    result.deployment.meta.update(
        oracle_fraction=result.oracle_fraction,
        classifier_fraction=result.classifier_fraction,
    )
    result.deployment.save(path)


# ---------------------------------------------------------------------------
# fleet tuning: several devices, one bundle (the deploy-anywhere artifact)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetTuneResult:
    """Per-device tuning runs packed into one multi-device bundle."""

    bundle: "object"  # DeploymentBundle
    results: dict[str, TuneResult]


def default_fleet() -> tuple[str, ...]:
    """The fleet a host can tune: its card (when torch finds one) and ``host_cpu``."""
    import torch

    if torch.cuda.is_available():
        from .gpubench import card_name

        return (card_name(), "host_cpu")
    return ("host_cpu",)


def tune_fleet(
    arch_ids: list[str] | None = None,
    *,
    device_names: tuple[str, ...] | None = None,
    n_kernels: int = 8,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    classifier: str = "DecisionTreeA",
    max_problems: int | None = DEFAULT_MAX_PROBLEMS,
    cpu_problems: int = 8,
    seed: int = 0,
    families: list[str] | None = None,
    prune_ratio: float | None = None,
    measure_budget: float | str | None = None,
) -> FleetTuneResult:
    """Tune every device in one run and pack a :class:`DeploymentBundle`.

    ``device_names`` (default :func:`default_fleet`: this card and
    ``host_cpu``) may name this host's card, measured with the port's
    kernels through :func:`tune_for_archs`, and ``host_cpu``, measured with
    numpy (``core/cpubench.py``: the matmul family; every other family
    answers its default there).  A card other than this one, or a TPU,
    cannot be measured here and raises.  Devices tune in
    ``devices.transfer_order``.  ``prune_ratio`` / ``measure_budget`` apply
    to the card's tune.
    """
    from .bundle import DeploymentBundle
    from .devices import canonical_device_name, transfer_order

    device_names = tuple(device_names) if device_names is not None else default_fleet()
    if not device_names:
        raise ValueError("tune_fleet needs at least one device name")
    wanted = [f for f in (families if families is not None else family_names()) if f != "matmul"]
    results: dict[str, TuneResult] = {}
    for name in transfer_order([canonical_device_name(n) for n in device_names]):
        if name in results:
            continue
        if name == "host_cpu":
            from .cpubench import build_cpu_dataset
            from .cpubench import cpu_problems as cpu_problem_list

            ds = build_cpu_dataset(cpu_problem_list(cpu_problems))
            res = tune(
                ds, n_kernels=n_kernels, method=method, normalization=normalization,
                classifier=classifier, seed=seed, arch_ids=arch_ids, families=[],
            )
        else:
            res = tune_for_archs(
                arch_ids, device_name=name, n_kernels=n_kernels, method=method,
                normalization=normalization, classifier=classifier,
                max_problems=max_problems, seed=seed, families=wanted,
                prune_ratio=prune_ratio, measure_budget=measure_budget,
            )
        res.deployment.meta.update(
            oracle_fraction=res.oracle_fraction,
            classifier_fraction=res.classifier_fraction,
        )
        results[name] = res
    meta = {
        "devices": sorted(results),
        "archs": list(arch_ids) if arch_ids else "all",
        "families": ["matmul", *wanted],
        "n_kernels": n_kernels,
        "method": method,
        "normalization": normalization,
        "seed": seed,
    }
    bundle = DeploymentBundle(
        deployments={name: r.deployment for name, r in results.items()},
        meta=meta,
    )
    return FleetTuneResult(bundle=bundle, results=results)


def save_fleet(result: FleetTuneResult, path: str | Path) -> None:
    result.bundle.save(path)
