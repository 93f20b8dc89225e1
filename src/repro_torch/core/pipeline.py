"""The tuning pipeline: candidates -> measure -> select -> classify.

Ported from ``repro/core/pipeline.py``, its default-knob path: no pruning,
no measurement budget, no transfer donor.  The stages:

  1. :func:`generate_candidates` — harvest the problems and enumerate the
     config space for one family (free).
  2. :func:`prune_candidates` — keeps the whole space (``prune_ratio=None``:
     the model-guided cut needs a family ``model_matrix``, which the port has
     not got yet).
  3. :func:`plan_measurements` — every (problem, config) cell.
  4. :func:`run_measurements` — one dense ``perf_matrix`` call: on the card,
     the measured table of ``core/gpubench.py``.
  5. cluster-select + classify (:func:`run_family_pipeline`) — the paper
     pipeline (normalize, ``cluster.select_configs``, fit the family tree).

:func:`tune_dataset` runs the paper pipeline on a matmul table and every
requested family.  Each run stamps a lineage record into
``Deployment.meta["tuning_lineage"]`` (all cells measured, and the seconds
spent measuring).  The transfer, prune and budget knobs join with the staged
pipeline and an H100 ``model_matrix``; the signatures here do not take them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .cluster import select_configs
from .dataset import TuningDataset
from .dispatch import classifier_fraction, train_deployment
from .families import KernelFamily, get_family
from .normalize import normalize
from .selection import achievable_fraction, geomean_fraction, select_from_dataset


# ---------------------------------------------------------------------------
# per-stage results
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CandidateStage:
    """Stage 1: the full search space for one (family, device) tune."""

    family: str
    device: str | None
    problems: list[tuple]
    configs: list  # the full config space, in registry order


@dataclasses.dataclass(frozen=True)
class PruneStage:
    """Stage 2: the kept configs (indices into ``CandidateStage.configs``)."""

    kept: tuple[int, ...]
    predicted: np.ndarray | None
    ratio: float


@dataclasses.dataclass(frozen=True)
class MeasurePlan:
    """Stage 3: which (problem, kept-config) cells to measure: all of them."""

    mask: np.ndarray


@dataclasses.dataclass(frozen=True)
class MeasureStage:
    """Stage 4: the benchmark table and its cost accounting.

    ``perf`` is (n_problems, n_kept), every cell measured; ``seconds`` is the
    wall time the measurement took.
    """

    perf: np.ndarray
    measured_mask: np.ndarray
    n_measured: int
    full_cost: int
    measured_fraction: float
    seconds: float


@dataclasses.dataclass
class FamilyPipelineResult:
    """One family through all stages, with every intermediate kept."""

    family: str
    device: str | None
    candidates: CandidateStage
    prune: PruneStage
    measure: MeasureStage
    chosen: list[int]  # indices into the FULL config space
    configs: list  # the deployed subset (objects)
    tree: object
    oracle_fraction: float
    classifier_fraction: float
    lineage: dict

    def to_family_result(self):
        """The ``tuner.FamilyTuneResult`` view of this run."""
        from .tuner import FamilyTuneResult

        return FamilyTuneResult(
            family=self.family,
            configs=self.configs,
            tree=self.tree,
            problems=self.candidates.problems,
            oracle_fraction=self.oracle_fraction,
            classifier_fraction=self.classifier_fraction,
            lineage=self.lineage,
        )


# ---------------------------------------------------------------------------
# stages 1-4
# ---------------------------------------------------------------------------
def generate_candidates(
    family: str | KernelFamily,
    arch_ids: list[str] | None = None,
    *,
    problems: list[tuple] | None = None,
    device_name: str | None = None,
) -> CandidateStage:
    """Harvest the problems and enumerate the config space for one family."""
    fam = family if isinstance(family, KernelFamily) else get_family(family)
    space = list(fam.config_space())
    problems = list(problems if problems is not None else fam.harvest(arch_ids))
    if not problems:
        raise ValueError(f"no benchmark problems harvested for family {fam.name!r}")
    return CandidateStage(family=fam.name, device=device_name, problems=problems, configs=space)


def prune_candidates(cand: CandidateStage) -> PruneStage:
    """Keep the whole config space (the reference at ``prune_ratio=None``)."""
    return PruneStage(kept=tuple(range(len(cand.configs))), predicted=None, ratio=1.0)


def plan_measurements(cand: CandidateStage, prune: PruneStage) -> MeasurePlan:
    """Measure every kept cell (there is no model table to fill gaps from)."""
    return MeasurePlan(mask=np.ones((len(cand.problems), len(prune.kept)), dtype=bool))


def run_measurements(cand: CandidateStage, prune: PruneStage, plan: MeasurePlan) -> MeasureStage:
    """Execute the plan: one dense ``perf_matrix`` call over the kept configs."""
    fam = get_family(cand.family)
    if not plan.mask.all():
        raise ValueError("partial measurement plans need the staged pipeline (not ported yet)")
    kept_cfgs = [cand.configs[j] for j in prune.kept]
    t0 = time.perf_counter()
    perf = np.asarray(fam.perf_matrix(cand.problems, kept_cfgs, cand.device), dtype=np.float64)
    seconds = time.perf_counter() - t0
    n_measured = int(plan.mask.sum())
    full_cost = len(cand.problems) * len(cand.configs)
    return MeasureStage(
        perf=perf,
        measured_mask=plan.mask,
        n_measured=n_measured,
        full_cost=full_cost,
        measured_fraction=n_measured / max(full_cost, 1),
        seconds=seconds,
    )


def _lineage_record(n_measured: int, full_cost: int, seconds: float | None) -> dict:
    """JSON-ready provenance for one family's tune (``meta["tuning_lineage"]``)."""
    return {
        "source_device": None,
        "prune_ratio": 1.0,
        "measured_fraction": round(n_measured / max(full_cost, 1), 6),
        "model_error": None,
        "n_measured": int(n_measured),
        "full_cost": int(full_cost),
        "measure_seconds": None if seconds is None else round(float(seconds), 3),
    }


# ---------------------------------------------------------------------------
# stage 5: the full per-family pipeline
# ---------------------------------------------------------------------------
def run_family_pipeline(
    family: str | KernelFamily,
    arch_ids: list[str] | None = None,
    *,
    problems: list[tuple] | None = None,
    device_name: str | None = None,
    n_kernels: int | None = None,
    method: str = "pca_kmeans",
    normalization: str = "standard",
    seed: int = 0,
) -> FamilyPipelineResult:
    """Every stage for one registered family (any family, matmul included)."""
    fam = family if isinstance(family, KernelFamily) else get_family(family)
    cand = generate_candidates(fam, arch_ids, problems=problems, device_name=device_name)
    prune = prune_candidates(cand)
    plan = plan_measurements(cand, prune)
    measure = run_measurements(cand, prune, plan)

    kept_cfgs = [cand.configs[j] for j in prune.kept]
    norm = normalize(measure.perf, normalization)
    feats = fam.features(cand.problems)
    k = min(n_kernels or fam.default_n_kernels, len(kept_cfgs))
    chosen_local = select_configs(norm, k, method, features=feats, seed=seed)
    labels = measure.perf[:, chosen_local].argmax(axis=1)
    tree = fam.make_tree(seed).fit(feats, labels)
    pred = np.clip(tree.predict(feats), 0, len(chosen_local) - 1)
    picked = measure.perf[np.arange(len(cand.problems)), [chosen_local[i] for i in pred]]
    return FamilyPipelineResult(
        family=fam.name,
        device=device_name,
        candidates=cand,
        prune=prune,
        measure=measure,
        chosen=[int(prune.kept[i]) for i in chosen_local],
        configs=[kept_cfgs[i] for i in chosen_local],
        tree=tree,
        oracle_fraction=achievable_fraction(measure.perf, chosen_local),
        classifier_fraction=geomean_fraction(picked, measure.perf.max(axis=1)),
        lineage=_lineage_record(measure.n_measured, measure.full_cost, measure.seconds),
    )


# ---------------------------------------------------------------------------
# the dataset-anchored tune
# ---------------------------------------------------------------------------
DEFAULT_FAMILIES = ("attention",)  # the non-matmul families with a measured H100 source


def tune_dataset(
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
):
    """The full paper pipeline on a matmul benchmark dataset, then every
    requested family (``families``, default ``["attention"]``, the non-matmul
    families with a measured H100 source; asking for ``wkv`` or ``ssm_scan``
    raises).
    """
    from .retune import train_distribution
    from .tuner import FamilyTuneResult, TuneResult, tune_family

    train, test = dataset.split(test_fraction=test_fraction, seed=seed)
    chosen = select_from_dataset(train, n_kernels, method, normalization, seed=seed)
    deployment = train_deployment(
        train,
        chosen,
        classifier,
        seed=seed,
        meta={
            "method": method,
            "normalization": normalization,
            "n_kernels": n_kernels,
            "seed": seed,
            "source": dataset.source,
            # Provenance for the continuous tuning loop (DESIGN.md §8): the
            # shape distribution this artifact was tuned against.
            "train_distribution": train_distribution(train.problems),
        },
    )
    wanted = [f for f in (families if families is not None else DEFAULT_FAMILIES) if f != "matmul"]
    family_results: dict[str, FamilyTuneResult] = {}
    family_dists: dict[str, dict] = {}
    lineage_out: dict[str, dict] = {}
    for fname in wanted:
        fam = get_family(fname)
        probs = fam.harvest(arch_ids)
        if not probs:
            continue  # none of the assigned archs launch this op: stays untuned
        got = tune_family(
            fname, problems=probs, method=method, normalization=normalization,
            seed=seed, n_kernels=n_attn_kernels if fname == "attention" else None,
            # A device-sensitive family is measured on the dataset's device.
            device_name=dataset.device if fam.device_sensitive else None,
        )
        deployment.set_family_tuning(fname, got.configs, got.tree)
        family_results[fname] = got
        family_dists[fname] = train_distribution(got.problems)
        lineage_out[fname] = got.lineage
    if family_dists:
        deployment.meta["family_distributions"] = family_dists
    n_cells = int(np.asarray(dataset.perf).size)
    lineage_out["matmul"] = _lineage_record(n_cells, n_cells, None)  # the caller that measured it fills the seconds
    deployment.meta["tuning_lineage"] = {k: lineage_out[k] for k in sorted(lineage_out)}
    return TuneResult(
        deployment=deployment,
        chosen=chosen,
        oracle_fraction=achievable_fraction(test.perf, chosen),
        classifier_fraction=classifier_fraction(test, chosen, deployment),
        train=train,
        test=test,
        family_results=family_results,
    )
