"""Staged tuning pipeline: candidates -> prune -> transfer -> measure -> select -> classify.

Ported from ``repro/core/pipeline.py``.  Measurement is the expensive stage
(on the card: every compiled config timed on every harvested problem, see
``core/gpubench.py``), and much of it is predictable, so the tune is broken
into explicit stages with per-stage results:

  1. :func:`generate_candidates` — harvest the problems and enumerate the
     config space for one family (free).
  2. :func:`prune_candidates` — rank configs by the family's H100 model
     (``KernelFamily.model_matrix``: ``core/perfmodel.py``,
     ``core/attnmodel.py``, ``core/recmodel.py``) and drop the ones it
     predicts far off the best everywhere.  Nothing has been measured yet.
  3. transfer warm-start (:func:`as_transfer_prior` + :func:`plan_measurements`)
     — with a tuned donor (a deployment of the same card, or of a sibling),
     reuse its chosen subset as ``cluster.kmeans(init_centers=...)`` seeds and
     its classifier as a prior: a problem row is only measured where the
     model and the donor *disagree* about the best surviving config.
  4. :func:`run_measurements` — execute the plan; measured cells come from
     the card (``perf_matrix``), unmeasured ones are filled from the model
     (GFLOP/s beside GFLOP/s, as the reference fills them).  The
     measured-cell count is the honest cost; ``model_error`` records how far
     the model is from the cells measured.
  5. cluster-select + classify (:func:`run_family_pipeline`) — the paper
     pipeline (normalize, ``cluster.select_configs``, fit the family tree)
     over the hybrid table.

Every run stamps a lineage record (source device, prune ratio, measured
fraction, model error, cells) into ``Deployment.meta["tuning_lineage"]``,
the reference's record exactly; the seconds the card spent measuring are
kept on the stage results (``MeasureStage.seconds``) and
``tuner.tune_for_archs`` stamps them into ``meta["measure_seconds"]``.

With every stage knob at its default the pipeline reproduces the
full-measurement tune: one dense ``perf_matrix`` call, cold clustering.
One difference from the reference: ``tune_dataset`` hands the donor to every
device-sensitive family (all four here, whose tables are the card's own),
where the reference's donor reaches only matmul (its other families are
tuned once per fleet against one model).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from .cluster import select_configs
from .dataset import TuningDataset
from .dispatch import Deployment, classifier_fraction, train_deployment
from .families import KernelFamily, family_names, get_family
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
    """Stage 2: the model-guided cut of the config space.

    ``kept`` are indices into ``CandidateStage.configs`` (ascending, so
    downstream matrices keep a stable column order); ``predicted`` is the
    model-side perf table over the *full* space (None when the family has no
    ``model_matrix`` or no stage needed it); ``ratio`` is the surviving
    fraction of the space.
    """

    kept: tuple[int, ...]
    predicted: np.ndarray | None
    ratio: float


@dataclasses.dataclass(frozen=True)
class TransferPrior:
    """A tuned sibling's artifact, normalized for warm-starting.

    ``configs``/``tree`` are the donor's deployed subset and classifier for
    the family being tuned; ``source_device`` is recorded in lineage.
    """

    configs: list
    tree: object | None
    source_device: str | None = None


@dataclasses.dataclass(frozen=True)
class MeasurePlan:
    """Stage 3: which (problem, kept-config) cells to actually measure.

    ``mask`` is (n_problems, n_kept) booleans; ``agreed_rows`` counts the
    problems where model and donor agreed (skipped entirely); ``capped_rows``
    counts planned rows dropped to honor ``measure_budget``.
    """

    mask: np.ndarray
    agreed_rows: int = 0
    capped_rows: int = 0


@dataclasses.dataclass(frozen=True)
class MeasureStage:
    """Stage 4: the hybrid benchmark table and its honest cost accounting.

    ``perf`` is (n_problems, n_kept): measured where the plan said so,
    model-filled elsewhere.  ``full_cost`` is what a from-scratch harvest
    would have measured (n_problems x the *full* config space), so
    ``measured_fraction`` is directly the paper-facing cost saving.
    ``model_error`` is the mean relative |predicted - measured| / measured
    over the cells where both exist — the lineage record's calibration
    figure.  ``seconds`` is the wall time the measurement took.
    """

    perf: np.ndarray
    measured_mask: np.ndarray
    n_measured: int
    full_cost: int
    measured_fraction: float
    model_error: float | None
    seconds: float = 0.0


@dataclasses.dataclass
class FamilyPipelineResult:
    """One family through all six stages, with every intermediate kept."""

    family: str
    device: str | None
    candidates: CandidateStage
    prune: PruneStage
    transfer: TransferPrior | None
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
            measure_seconds=self.measure.seconds,
            perf=self.measure.perf,
            kept=self.prune.kept,
        )


# ---------------------------------------------------------------------------
# stage 1: candidates
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


# ---------------------------------------------------------------------------
# stage 2: model-guided pruning
# ---------------------------------------------------------------------------
def prune_candidates(
    cand: CandidateStage,
    *,
    prune_ratio: float | None = None,
    keep_configs: list | tuple = (),
    with_model: bool = False,
) -> PruneStage:
    """Drop configs the family's perf model predicts are never competitive.

    Each config is scored by its best predicted fraction-of-roofline-best
    over all problems; the top ``ceil(prune_ratio * n_space)`` survive.  The
    family's default config and every entry of ``keep_configs`` (a transfer
    donor's deployed subset) are always kept — pruning must never make the
    donor's prior unexpressable.  ``with_model=True`` computes the model
    table even when no pruning happens (later stages need it for
    disagreement planning and model-fill).  A family without a
    ``model_matrix`` keeps everything.
    """
    fam = get_family(cand.family)
    n_space = len(cand.configs)
    pruning = (
        prune_ratio is not None and 0.0 < prune_ratio < 1.0 and fam.model_matrix is not None
    )
    predicted = None
    if (pruning or with_model) and fam.model_matrix is not None:
        predicted = np.asarray(
            fam.model_matrix(cand.problems, cand.configs, cand.device), dtype=np.float64
        )
    if not pruning:
        return PruneStage(kept=tuple(range(n_space)), predicted=predicted, ratio=1.0)

    best = predicted.max(axis=1, keepdims=True)
    frac = np.where(best > 0, predicted / np.maximum(best, 1e-30), 0.0)
    score = frac.max(axis=0)  # best-case competitiveness of each config
    n_keep = min(n_space, max(int(math.ceil(prune_ratio * n_space)), 1))
    order = np.argsort(-score, kind="stable")
    kept = set(int(j) for j in order[:n_keep])
    forced = list(keep_configs)
    if fam.default_config is not None:
        forced.append(fam.default_config)
    for cfg in forced:
        j = _config_index(cand.configs, cfg)
        if j is not None:
            kept.add(j)
    kept_t = tuple(sorted(kept))
    return PruneStage(kept=kept_t, predicted=predicted, ratio=len(kept_t) / max(n_space, 1))


def _config_index(configs: list, cfg) -> int | None:
    try:
        return configs.index(cfg)
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# stage 3: the measurement plan (where model and prior disagree)
# ---------------------------------------------------------------------------
def plan_measurements(
    cand: CandidateStage,
    prune: PruneStage,
    *,
    donor: TransferPrior | None = None,
    measure_budget: float | None = None,
) -> MeasurePlan:
    """Decide which cells of the kept (problems x configs) table to measure.

    Without a model table every kept cell is measured (there is nothing to
    fill the gaps with, so ``measure_budget`` cannot apply).  With a model
    but no donor, all kept cells are planned and the budget drops the rows
    whose predicted perf *spread* is smallest (the model is confident the
    choice barely matters there).  With a donor, a row is planned only when
    the model's best surviving config and the donor classifier's pick
    disagree — agreement means two independent priors concur and the row is
    served model-filled; the budget keeps the rows with the largest
    predicted cost of picking wrong.

    ``measure_budget`` is a fraction of the *full-harvest* cell count
    (n_problems x full config space), matching the lineage accounting.
    """
    n = len(cand.problems)
    m = len(prune.kept)
    mask = np.ones((n, m), dtype=bool)
    if prune.predicted is None:
        return MeasurePlan(mask=mask)

    pred_kept = prune.predicted[:, list(prune.kept)]
    agreed = 0
    if donor is not None and donor.configs:
        fam = get_family(cand.family)
        donor_col = _donor_columns(fam, cand, prune, donor)
        model_col = pred_kept.argmax(axis=1)
        # Stakes of a wrong pick, per row: predicted loss of taking the
        # donor's config instead of the model's best surviving one.
        best = pred_kept[np.arange(n), model_col]
        donor_pred = np.where(
            donor_col >= 0, pred_kept[np.arange(n), np.maximum(donor_col, 0)], 0.0
        )
        gap = np.where(best > 0, 1.0 - donor_pred / np.maximum(best, 1e-30), 1.0)
        agree = (donor_col == model_col) & (donor_col >= 0)
        mask[agree] = False
        agreed = int(agree.sum())
        priority = np.where(agree, -1.0, gap)
    else:
        # No donor: the budget keeps the rows where config choice matters
        # most (largest predicted relative spread among valid configs).
        pos = np.where(pred_kept > 0, pred_kept, np.nan)
        with np.errstate(invalid="ignore"):
            lo = np.nanmin(pos, axis=1)
            hi = np.nanmax(pos, axis=1)
        priority = np.where(np.isfinite(hi) & (hi > 0), 1.0 - lo / np.maximum(hi, 1e-30), 0.0)

    capped = 0
    if measure_budget is not None and 0.0 < measure_budget < 1.0:
        budget_cells = int(measure_budget * n * len(cand.configs))
        planned_rows = np.where(mask.any(axis=1))[0]
        max_rows = budget_cells // max(m, 1)
        if len(planned_rows) > max_rows:
            order = planned_rows[np.argsort(-priority[planned_rows], kind="stable")]
            for i in order[max_rows:]:
                mask[i] = False
            capped = len(planned_rows) - max_rows
    return MeasurePlan(mask=mask, agreed_rows=agreed, capped_rows=capped)


def _donor_columns(
    fam: KernelFamily, cand: CandidateStage, prune: PruneStage, donor: TransferPrior
) -> np.ndarray:
    """Per-problem kept-column index of the donor classifier's pick (-1 = n/a)."""
    kept_cfgs = [cand.configs[j] for j in prune.kept]
    col_of = {}
    for col, cfg in enumerate(kept_cfgs):
        try:
            col_of.setdefault(cfg, col)
        except TypeError:  # unhashable config type: fall back to .index below
            col_of = None
            break
    feats = fam.features(cand.problems)
    if donor.tree is not None:
        idx = np.clip(np.asarray(donor.tree.predict(feats), dtype=int), 0, len(donor.configs) - 1)
    else:
        idx = np.zeros(len(cand.problems), dtype=int)
    out = np.full(len(cand.problems), -1, dtype=int)
    for i, di in enumerate(idx):
        cfg = donor.configs[int(di)]
        if col_of is not None:
            out[i] = col_of.get(cfg, -1)
        else:
            j = _config_index(kept_cfgs, cfg)
            out[i] = -1 if j is None else j
    return out


# ---------------------------------------------------------------------------
# stage 4: measurement
# ---------------------------------------------------------------------------
def run_measurements(
    cand: CandidateStage, prune: PruneStage, plan: MeasurePlan
) -> MeasureStage:
    """Execute the plan: measured cells from ``perf_matrix``, rest model-filled."""
    fam = get_family(cand.family)
    kept = list(prune.kept)
    kept_cfgs = [cand.configs[j] for j in kept]
    n = len(cand.problems)
    full_cost = n * len(cand.configs)
    mask = plan.mask

    t0 = time.perf_counter()
    if mask.all():
        # The full-harvest path: one dense perf_matrix call.
        perf = np.asarray(fam.perf_matrix(cand.problems, kept_cfgs, cand.device), dtype=np.float64)
    else:
        if prune.predicted is None:
            raise ValueError("partial measurement plans require a family model_matrix")
        perf = prune.predicted[:, kept].copy()
        for i in np.where(mask.any(axis=1))[0]:
            cols = np.where(mask[i])[0]
            row = fam.perf_matrix(
                [cand.problems[i]], [kept_cfgs[c] for c in cols], cand.device
            )
            perf[i, cols] = np.asarray(row, dtype=np.float64)[0]
    seconds = time.perf_counter() - t0

    n_measured = int(mask.sum())
    model_error = None
    if prune.predicted is not None and n_measured:
        pred = prune.predicted[:, kept]
        sel = mask & (perf > 0) & (pred > 0)
        if sel.any():
            model_error = float(np.mean(np.abs(pred[sel] - perf[sel]) / perf[sel]))
    return MeasureStage(
        perf=perf,
        measured_mask=mask,
        n_measured=n_measured,
        full_cost=full_cost,
        measured_fraction=n_measured / max(full_cost, 1),
        model_error=model_error,
        seconds=seconds,
    )


# ---------------------------------------------------------------------------
# transfer priors + warm starts
# ---------------------------------------------------------------------------
def as_transfer_prior(obj, family: str) -> TransferPrior | None:
    """Normalize anything tuned into a :class:`TransferPrior` for ``family``.

    Accepts a :class:`TransferPrior`, a ``Deployment`` (or anything with a
    ``.deployment``, e.g. a ``TuneResult``), a ``FamilyTuneResult`` /
    ``FamilyTuning``, or a bare ``(configs, tree)`` tuple.  Returns ``None``
    for ``None`` or an empty prior.
    """
    if obj is None:
        return None
    if isinstance(obj, TransferPrior):
        return obj if obj.configs else None
    dep = getattr(obj, "deployment", obj)
    if isinstance(dep, Deployment):
        cfgs, tree = dep.family_tuning(family)
        if not cfgs:
            return None
        return TransferPrior(list(cfgs), tree, source_device=dep.device)
    if hasattr(obj, "configs") and hasattr(obj, "tree"):
        cfgs = list(obj.configs)
        if not cfgs:
            return None
        return TransferPrior(cfgs, obj.tree, source_device=getattr(obj, "source_device", None))
    cfgs, tree = obj  # bare (configs, tree)
    return TransferPrior(list(cfgs), tree, None) if cfgs else None


def warm_start_centers(
    norm_perf: np.ndarray, all_configs: list, perf: np.ndarray, deployed_configs: list
) -> np.ndarray | None:
    """Perf-space centroids implied by an existing deployed kernel subset.

    Problems are grouped by which *deployed* config is best for them (the
    clustering the prior artifact effectively shipped); each group's mean
    normalized perf vector seeds one k-means center.  Deployed configs
    missing from the config space are skipped (k-means++ tops up).  Shared
    by the transfer warm-start here and the reference's incremental retune.
    """
    cols = []
    for cfg in deployed_configs:
        j = _config_index(all_configs, cfg)
        if j is not None:
            cols.append(j)
    if not cols:
        return None
    owner = np.asarray(perf)[:, cols].argmax(axis=1)
    centers = []
    for j in range(len(cols)):
        members = norm_perf[owner == j]
        if len(members):
            centers.append(members.mean(axis=0))
    return np.stack(centers) if centers else None


def _lineage_record(
    measure: MeasureStage, prune: PruneStage, donor: TransferPrior | None
) -> dict:
    """JSON-ready provenance for one family's tune (bundle ``tuning_lineage``)."""
    return {
        "source_device": donor.source_device if donor is not None else None,
        "prune_ratio": round(float(prune.ratio), 6),
        "measured_fraction": round(float(measure.measured_fraction), 6),
        "model_error": (
            round(float(measure.model_error), 6) if measure.model_error is not None else None
        ),
        "n_measured": int(measure.n_measured),
        "full_cost": int(measure.full_cost),
    }


# ---------------------------------------------------------------------------
# measure-budget auto-sizing
# ---------------------------------------------------------------------------
AUTO_BUDGET_FLOOR = 0.10
AUTO_BUDGET_CEIL = 0.75
AUTO_BUDGET_DEFAULT = 0.35


def auto_measure_budget(
    model_error: float | None,
    *,
    floor: float = AUTO_BUDGET_FLOOR,
    ceil: float = AUTO_BUDGET_CEIL,
    default: float = AUTO_BUDGET_DEFAULT,
) -> float:
    """Size a measurement budget from a donor's recorded model error.

    The staged pipeline stamps each family's transfer-model quality into
    ``tuning_lineage.model_error`` (mean relative error of the perf model on
    held-out measured cells).  A low error means the donor's model predicts
    this device pair well, so few confirmation measurements are needed; a
    high error means the transfer is unreliable and the budget should grow
    toward a full harvest.  The mapping is linear — ``0.05 + 3 * error`` —
    clipped to ``[floor, ceil]``; with no recorded error we fall back to a
    conservative ``default``.
    """
    if model_error is None:
        return default
    return min(ceil, max(floor, 0.05 + 3.0 * float(model_error)))


def donor_model_error(transfer_from, family: str = "matmul") -> float | None:
    """Pull ``tuning_lineage[family].model_error`` out of a donor, if stamped."""
    if transfer_from is None:
        return None
    dep = getattr(transfer_from, "deployment", transfer_from)
    meta = getattr(dep, "meta", None)
    if not isinstance(meta, dict):
        return None
    record = (meta.get("tuning_lineage") or {}).get(family)
    if not isinstance(record, dict):
        return None
    err = record.get("model_error")
    return float(err) if err is not None else None


def resolve_measure_budget(
    measure_budget, transfer_from=None, *, family: str = "matmul"
) -> float | None:
    """Resolve the ``"auto"`` sentinel into a concrete budget fraction.

    Floats and ``None`` pass through untouched.  ``"auto"`` resolves per
    device pair: with no donor there is nothing to transfer from, so the
    root of the bring-up order measures in full (``None``); with a donor,
    the budget is sized by :func:`auto_measure_budget` from the lineage
    ``model_error`` the donor's own tune recorded for ``family``.
    """
    if measure_budget != "auto":
        return measure_budget
    if transfer_from is None:
        return None
    return auto_measure_budget(donor_model_error(transfer_from, family))


# ---------------------------------------------------------------------------
# stages 5+6: the full per-family pipeline
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
    prune_ratio: float | None = None,
    measure_budget: float | str | None = None,
    transfer_from=None,
) -> FamilyPipelineResult:
    """All six stages for one registered family (any family, matmul included).

    With every stage knob at its default (no prune, no budget, no donor)
    every cell is measured.  The donor
    (``transfer_from``, anything :func:`as_transfer_prior` accepts) supplies
    both the k-means warm start and the measure-only-disagreements plan.
    ``measure_budget="auto"`` sizes the budget from the donor's recorded
    lineage via :func:`resolve_measure_budget`.
    """
    fam = family if isinstance(family, KernelFamily) else get_family(family)
    measure_budget = resolve_measure_budget(measure_budget, transfer_from, family=fam.name)
    cand = generate_candidates(fam, arch_ids, problems=problems, device_name=device_name)
    donor = as_transfer_prior(transfer_from, fam.name)
    need_model = donor is not None or (
        measure_budget is not None and 0.0 < measure_budget < 1.0
    )
    prune = prune_candidates(
        cand,
        prune_ratio=prune_ratio,
        keep_configs=donor.configs if donor is not None else (),
        with_model=need_model,
    )
    plan = plan_measurements(cand, prune, donor=donor, measure_budget=measure_budget)
    measure = run_measurements(cand, prune, plan)

    kept_cfgs = [cand.configs[j] for j in prune.kept]
    norm = normalize(measure.perf, normalization)
    feats = fam.features(cand.problems)
    k = min(n_kernels or fam.default_n_kernels, len(kept_cfgs))
    init_centers = None
    if donor is not None:
        init_centers = warm_start_centers(norm, kept_cfgs, measure.perf, donor.configs)
    chosen_local = select_configs(
        norm, k, method, features=feats, seed=seed, init_centers=init_centers
    )
    labels = measure.perf[:, chosen_local].argmax(axis=1)
    tree = fam.make_tree(seed).fit(feats, labels)
    pred = np.clip(tree.predict(feats), 0, len(chosen_local) - 1)
    picked = measure.perf[np.arange(len(cand.problems)), [chosen_local[i] for i in pred]]
    return FamilyPipelineResult(
        family=fam.name,
        device=device_name,
        candidates=cand,
        prune=prune,
        transfer=donor,
        measure=measure,
        chosen=[int(prune.kept[i]) for i in chosen_local],
        configs=[kept_cfgs[i] for i in chosen_local],
        tree=tree,
        oracle_fraction=achievable_fraction(measure.perf, chosen_local),
        classifier_fraction=geomean_fraction(picked, measure.perf.max(axis=1)),
        lineage=_lineage_record(measure, prune, donor),
    )


def staged_matmul_dataset(
    problems: list[tuple],
    device_name: str,
    *,
    prune_ratio: float | None = None,
    measure_budget: float | None = None,
    transfer_from=None,
) -> tuple[TuningDataset, dict, TransferPrior | None]:
    """The matmul benchmark table via the staged pipeline, plus its lineage.

    ``tune_for_archs`` calls this instead of measuring the full table when
    any stage knob is active: the returned :class:`TuningDataset` covers the
    *kept* configs with a measured/model-filled hybrid table, and the
    lineage record carries the cost accounting into ``Deployment.meta``.
    """
    donor = as_transfer_prior(transfer_from, "matmul")
    cand = generate_candidates("matmul", problems=problems, device_name=device_name)
    need_model = donor is not None or (
        measure_budget is not None and 0.0 < measure_budget < 1.0
    )
    prune = prune_candidates(
        cand,
        prune_ratio=prune_ratio,
        keep_configs=donor.configs if donor is not None else (),
        with_model=need_model,
    )
    plan = plan_measurements(cand, prune, donor=donor, measure_budget=measure_budget)
    measure = run_measurements(cand, prune, plan)
    ds = TuningDataset(
        device=device_name,
        problems=list(problems),
        configs=[cand.configs[j] for j in prune.kept],
        perf=measure.perf,
        source="pipeline",
        family="matmul",
    )
    return ds, _lineage_record(measure, prune, donor), donor


# ---------------------------------------------------------------------------
# the dataset-anchored tune
# ---------------------------------------------------------------------------
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
    transfer_from=None,
    prune_ratio: float | None = None,
    measure_budget: float | str | None = None,
    lineage: dict | None = None,
):
    """The full paper pipeline on a matmul benchmark dataset, then every
    requested family (``families``, default every registered one), staged.

    This is ``tuner.tune``'s implementation.  ``transfer_from`` warm-starts
    the matmul clustering from a donor's deployed subset and, in the port,
    is also every device-sensitive family's donor (the reference hands it to
    matmul only); ``prune_ratio`` / ``measure_budget`` thread into every
    family's :func:`run_family_pipeline`; ``lineage`` carries the matmul
    cost record from :func:`staged_matmul_dataset`.  Unlike the reference it
    takes no precomputed family tunings: a fleet shares none (every family of
    the port is device-sensitive).
    """
    from .retune import train_distribution
    from .tuner import FamilyTuneResult, TuneResult, tune_family

    train, test = dataset.split(test_fraction=test_fraction, seed=seed)
    donor = as_transfer_prior(transfer_from, "matmul")
    if donor is not None:
        norm = normalize(train.perf, normalization)
        centers = warm_start_centers(norm, train.configs, train.perf, donor.configs)
        chosen = select_configs(
            norm, n_kernels, method, features=train.features, seed=seed, init_centers=centers
        )
    else:
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
            # Provenance: the shape distribution this artifact was tuned against.
            "train_distribution": train_distribution(train.problems),
        },
    )
    wanted = [f for f in (families if families is not None else family_names()) if f != "matmul"]
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
            # A device-sensitive family is measured on the dataset's device,
            # and a donor of that device warm-starts it too.
            device_name=dataset.device if fam.device_sensitive else None,
            prune_ratio=prune_ratio, measure_budget=measure_budget,
            transfer_from=transfer_from if fam.device_sensitive else None,
        )
        deployment.set_family_tuning(fname, got.configs, got.tree)
        family_results[fname] = got
        family_dists[fname] = train_distribution(got.problems)
        if got.lineage:
            lineage_out[fname] = got.lineage
    if family_dists:
        deployment.meta["family_distributions"] = family_dists
    # Tuning lineage: how much evidence this artifact is actually based on.
    matmul_record = dict((lineage or {}).get("matmul") or {})
    if not matmul_record:
        n_cells = int(np.asarray(dataset.perf).size)
        matmul_record = {
            "source_device": donor.source_device if donor is not None else None,
            "prune_ratio": 1.0,
            "measured_fraction": 1.0,
            "model_error": None,
            "n_measured": n_cells,
            "full_cost": n_cells,
        }
    lineage_out["matmul"] = matmul_record
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
