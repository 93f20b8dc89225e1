"""Continuous tuning loop: telemetry -> drift detection -> incremental retune.

Ported from ``repro/core/retune.py``.  The paper's pipeline relies only on
benchmark data, but that data is frozen at tune time while the serving
engine sees the live problem distribution.  This module closes the loop:

    selection log + OnlinePolicy measurements
        -> TelemetrySnapshot            (per-(family, shape-bucket) histograms)
        -> detect_drift                 (per family, against the Deployment's
                                         training distribution, carried in its
                                         ``meta``)
        -> incremental_retune           (re-harvest only drifted buckets,
                                         warm-start clustering from the
                                         deployed centroids, refit the
                                         classifier traffic-weighted)
        -> canary_deployment            (selection quality on a holdout and a
                                         numeric probe of the candidate's
                                         config against the plain version)
        -> new Deployment               (hot-swapped into the serving engine's
                                         KernelRuntime, its programs captured
                                         again, no request dropped)

The matmul histogram lives in ``meta["train_distribution"]`` and every other
family's in ``meta["family_distributions"][family]``, so an ssm-only shift
retunes only the ssm family.

Benchmark data for a retune: by default the H100 model (``core/perfmodel.py``
through :func:`~repro_torch.core.dataset.build_model_dataset` for matmul, each
family's ``model_matrix`` for the rest), as the reference defaults to its TPU
model; ``dataset_builder=`` supplies the matmul table instead, e.g. measured
on the card with ``gpubench.build_gpu_dataset``.  The canary's selection
check scores on the same H100 model and abstains for a device it does not
model.  Its numeric probe runs the candidate's matmul and attention configs
through the hand-written kernels on the card (``device="cuda"``) against the
plain versions; on the CPU it compares the plain versions, as the reference
compares ``jnp.dot`` without Pallas.  The wkv and ssm_scan probes compare the
reference oracle with itself, as the reference's do (a gap of the reference,
ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .classify import fit_weighted, make_classifier
from .cluster import select_configs
from .dataset import TuningDataset, build_model_dataset
from .dispatch import Deployment, build_labels
from .families import get_family
from .normalize import normalize
from .online import shape_bucket

Bucket = tuple[int, ...]

DEFAULT_DRIFT_THRESHOLD = 0.15
DEFAULT_MIN_EVENTS = 32


# ---------------------------------------------------------------------------
# training-distribution provenance (Deployment.meta)
# ---------------------------------------------------------------------------
def bucket_key(bucket: Bucket) -> str:
    """JSON-safe bucket key: ``(9, 10, 9, 1)`` -> ``"9,10,9,1"``."""
    return ",".join(str(int(v)) for v in bucket)


def parse_bucket_key(key: str) -> Bucket:
    return tuple(int(v) for v in key.split(","))


def train_distribution(
    problems: list[tuple], weights: np.ndarray | None = None
) -> dict:
    """Provenance blob describing a tuning dataset's shape distribution.

    JSON-ready (it rides inside ``Deployment.meta``):

        {"buckets": {"9,10,9,1": {"w": 0.25, "problem": [512, 784, 512, 16]},
                     ...},
         "n_problems": 60}

    ``w`` is the bucket's share of (optionally weighted) problems; ``problem``
    is one representative shape per bucket, kept so an incremental retune can
    rebuild benchmark rows for undrifted buckets without the full dataset.
    """
    w = np.ones(len(problems)) if weights is None else np.asarray(weights, float)
    buckets: dict[str, dict] = {}
    total = float(w.sum()) or 1.0
    for p, wi in zip(problems, w):
        key = bucket_key(shape_bucket(p))
        ent = buckets.setdefault(key, {"w": 0.0, "problem": [int(v) for v in p]})
        ent["w"] += float(wi) / total
    return {"buckets": buckets, "n_problems": len(problems)}


def _dist_buckets(dist: dict | None) -> dict[Bucket, tuple[float, tuple]]:
    """Parse a provenance blob into ``{bucket: (weight, problem)}``."""
    if not dist or not dist.get("buckets"):
        return {}
    out = {}
    for key, ent in dist["buckets"].items():
        out[parse_bucket_key(key)] = (float(ent["w"]), tuple(int(v) for v in ent["problem"]))
    return out


def _deployment_distribution(deployment, family: str) -> dict | None:
    """The training-distribution provenance blob for one family."""
    if not isinstance(deployment, Deployment):
        return deployment  # caller passed the provenance dict itself
    if family == "matmul":
        return deployment.meta.get("train_distribution")
    return (deployment.meta.get("family_distributions") or {}).get(family)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TelemetrySnapshot:
    """Aggregated runtime evidence for one serving window.

    ``counts`` holds one live shape-bucket histogram per kernel family
    (every selection, shape-cache hits included, so frequencies reflect real
    traffic: a serving engine selects once per program build, as the
    reference selects once per trace); ``family_problems`` keeps the most
    recent concrete shape per ``(family, bucket)`` (the re-harvest
    candidates); ``observed`` carries measured config timings an
    :class:`~repro_torch.core.online.OnlinePolicy` gathered (bucket ->
    ``[(config, mean_s, trials)]``); ``incidents`` the runtime's incident
    records, newest last.
    """

    counts: dict[str, dict[Bucket, int]] = dataclasses.field(default_factory=dict)
    family_problems: dict[str, dict[Bucket, tuple]] = dataclasses.field(default_factory=dict)
    observed: dict[Bucket, list] = dataclasses.field(default_factory=dict)
    n_events: int = 0
    incidents: list[dict] = dataclasses.field(default_factory=list)

    # -- per-family views ----------------------------------------------------
    @property
    def matmul_counts(self) -> dict[Bucket, int]:
        return self.counts.setdefault("matmul", {})

    @property
    def attention_counts(self) -> dict[Bucket, int]:
        return self.counts.setdefault("attention", {})

    @property
    def problems(self) -> dict[Bucket, tuple]:
        return self.family_problems.setdefault("matmul", {})

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_selection_log(log: list[tuple], online=None) -> "TelemetrySnapshot":
        """Aggregate selection-log entries (op, problem, config); ``online``
        optionally supplies an ``OnlinePolicy`` whose ``measurements()`` are
        folded in as observed config timings."""
        snap = TelemetrySnapshot()
        for op, problem, _cfg in log:
            b = shape_bucket(problem)
            fam = snap.counts.setdefault(op, {})
            fam[b] = fam.get(b, 0) + 1
            snap.family_problems.setdefault(op, {})[b] = tuple(int(v) for v in problem)
            snap.n_events += 1
        if online is not None and hasattr(online, "measurements"):
            for b, rows in online.measurements().items():
                snap.observed.setdefault(b, []).extend(rows)
        return snap

    @staticmethod
    def from_runtime(runtime, online=None) -> "TelemetrySnapshot":
        """One :class:`~repro_torch.core.runtime.KernelRuntime`'s selection
        log and incidents."""
        snap = TelemetrySnapshot.from_selection_log(runtime.selection_log(), online=online)
        snap.incidents = runtime.incidents()
        return snap

    def families(self) -> list[str]:
        """Families with at least one recorded event, matmul first."""
        return sorted((f for f, c in self.counts.items() if c), key=lambda f: (f != "matmul", f))

    def family_events(self, family: str) -> int:
        return int(sum(self.counts.get(family, {}).values()))

    def histogram(self, family: str = "matmul") -> dict[Bucket, float]:
        """Normalized live traffic histogram for one family (sums to 1)."""
        fam = self.counts.get(family, {})
        total = float(sum(fam.values()))
        if total <= 0:
            return {}
        return {b: c / total for b, c in fam.items()}

    def merge(self, other: "TelemetrySnapshot") -> "TelemetrySnapshot":
        """Fold ``other`` into this snapshot, commutatively: counts and
        ``n_events`` add; the representative problem per bucket is the
        largest shape seen; ``observed`` rows and ``incidents`` are kept in a
        canonical sort."""
        for fname, fam in other.counts.items():
            mine = self.counts.setdefault(fname, {})
            for b, c in fam.items():
                mine[b] = mine.get(b, 0) + c
        for fname, probs in other.family_problems.items():
            mine_p = self.family_problems.setdefault(fname, {})
            for b, p in probs.items():
                prev = mine_p.get(b)
                mine_p[b] = p if prev is None else max(prev, tuple(p))
        for b, rows in other.observed.items():
            merged = self.observed.setdefault(b, [])
            merged.extend(rows)
            merged.sort(key=repr)
        if other.incidents:
            self.incidents = sorted(
                self.incidents + list(other.incidents),
                key=lambda r: (r.get("seq", 0), repr(sorted(r.items(), key=str))),
            )
        self.n_events += other.n_events
        return self

    # -- wire form -------------------------------------------------------------
    def to_json(self) -> dict:
        """JSON-ready wire form (the reference's, key for key): bucket tuples
        become ``bucket_key`` strings, observed configs their ``name()``."""
        def cfg_name(c):
            if c is None:
                return None
            return c.name() if hasattr(c, "name") and callable(c.name) else str(c)

        return {
            "version": 1,
            "counts": {
                fam: {bucket_key(b): int(c) for b, c in sorted(buckets.items())}
                for fam, buckets in sorted(self.counts.items())
            },
            "problems": {
                fam: {bucket_key(b): [int(v) for v in p] for b, p in sorted(probs.items())}
                for fam, probs in sorted(self.family_problems.items())
            },
            "observed": {
                bucket_key(b): [[cfg_name(cfg), float(mean), int(trials)] for cfg, mean, trials in rows]
                for b, rows in sorted(self.observed.items())
            },
            "incidents": [dict(r) for r in self.incidents],
            "n_events": int(self.n_events),
        }

    @staticmethod
    def from_json(blob: dict) -> "TelemetrySnapshot":
        """Parse the :meth:`to_json` wire form back (observed configs come
        back as their name strings)."""
        snap = TelemetrySnapshot()
        for fam, buckets in (blob.get("counts") or {}).items():
            snap.counts[fam] = {parse_bucket_key(k): int(c) for k, c in buckets.items()}
        for fam, probs in (blob.get("problems") or {}).items():
            snap.family_problems[fam] = {
                parse_bucket_key(k): tuple(int(v) for v in p) for k, p in probs.items()
            }
        for k, rows in (blob.get("observed") or {}).items():
            snap.observed[parse_bucket_key(k)] = [(cfg, float(mean), int(trials)) for cfg, mean, trials in rows]
        snap.incidents = [dict(r) for r in blob.get("incidents") or []]
        snap.n_events = int(blob.get("n_events", 0))
        return snap


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Outcome of comparing live traffic against the training distribution.

    ``score`` is the Jensen-Shannon divergence (base 2: 0 identical, 1
    disjoint) between the two bucket histograms; ``unseen_fraction`` the live
    mass on buckets the tuning dataset never held; ``drifted_buckets`` the
    re-harvest targets, heaviest excess live mass first.
    """

    score: float
    unseen_fraction: float
    drifted_buckets: tuple[Bucket, ...]
    threshold: float
    n_events: int
    triggered: bool
    family: str = "matmul"


def js_divergence(p: dict[Bucket, float], q: dict[Bucket, float]) -> float:
    """Jensen-Shannon divergence between two bucket histograms, in [0, 1]."""
    keys = sorted(set(p) | set(q))
    if not keys:
        return 0.0
    pv = np.array([p.get(k, 0.0) for k in keys])
    qv = np.array([q.get(k, 0.0) for k in keys])
    pv = pv / max(pv.sum(), 1e-12)
    qv = qv / max(qv.sum(), 1e-12)
    m = 0.5 * (pv + qv)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / np.maximum(b[mask], 1e-300))))

    return 0.5 * kl(pv, m) + 0.5 * kl(qv, m)


def detect_drift(
    snapshot: TelemetrySnapshot,
    deployment: Deployment | dict | None,
    *,
    family: str = "matmul",
    threshold: float = DEFAULT_DRIFT_THRESHOLD,
    min_events: int = DEFAULT_MIN_EVENTS,
) -> DriftReport:
    """Compare one family's live traffic against its training distribution.

    An artifact without provenance for the family scores 1.0: past the event
    floor it always triggers a retune to the observed distribution.
    """
    dist = _deployment_distribution(deployment, family)
    live = snapshot.histogram(family)
    n_events = snapshot.family_events(family)
    train = {b: w for b, (w, _p) in _dist_buckets(dist).items()}
    if not live:
        return DriftReport(0.0, 0.0, (), threshold, n_events, False, family)
    if not train:
        drifted = tuple(sorted(live, key=lambda b: -live[b]))
        return DriftReport(1.0, 1.0, drifted, threshold, n_events, n_events >= min_events, family)
    score = js_divergence(live, train)
    unseen = sum(w for b, w in live.items() if b not in train)
    # Re-harvest targets: buckets with materially more live than train mass.
    excess = {b: live[b] - train.get(b, 0.0) for b in live}
    margin = 0.5 / max(len(live), 1)
    drifted = tuple(sorted((b for b, e in excess.items() if e > margin or b not in train),
                           key=lambda b: -excess[b]))
    triggered = n_events >= min_events and score >= threshold
    return DriftReport(score, unseen, drifted, threshold, n_events, triggered, family)


def detect_drift_all(
    snapshot: TelemetrySnapshot,
    deployment: Deployment | None,
    *,
    threshold: float = DEFAULT_DRIFT_THRESHOLD,
    min_events: int = DEFAULT_MIN_EVENTS,
) -> dict[str, DriftReport]:
    """One :func:`detect_drift` report per family with live traffic."""
    return {
        fam: detect_drift(snapshot, deployment, family=fam, threshold=threshold, min_events=min_events)
        for fam in snapshot.families()
    }


# ---------------------------------------------------------------------------
# incremental retune
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RetuneResult:
    deployment: Deployment
    report: DriftReport
    n_harvested: int  # buckets whose benchmark rows were newly measured
    n_problems: int  # total problems in the blended retune dataset
    warm_started: bool
    family: str = "matmul"


def _warm_start_centers(
    norm_perf: np.ndarray, all_configs: list, perf: np.ndarray, deployed_configs: list
) -> np.ndarray | None:
    """Perf-space centroids implied by the deployed kernel subset (a retune
    is a transfer from the deployment's own past)."""
    from .pipeline import warm_start_centers

    return warm_start_centers(norm_perf, all_configs, perf, deployed_configs)


def _blend_problems(
    train: dict[Bucket, tuple[float, tuple]],
    live: dict[Bucket, float],
    live_problems: dict[Bucket, tuple],
    drifted: set,
    blend: float,
) -> tuple[list[tuple], list[float], int]:
    """Blend train + live distributions into one weighted problem list:
    drifted buckets take their live representative (the fresh harvest),
    undrifted training buckets keep their provenance representative."""
    problems: list[tuple] = []
    weights: list[float] = []
    harvested = 0
    for b in sorted(set(train) | set(live)):
        t_w = train.get(b, (0.0, None))[0]
        l_w = live.get(b, 0.0)
        w = (1.0 - blend) * t_w + blend * l_w
        if w <= 0:
            continue
        if b in drifted and b in live_problems:
            problems.append(live_problems[b])
            harvested += 1
        elif b in train:
            problems.append(train[b][1])
        elif b in live_problems:
            problems.append(live_problems[b])
            harvested += 1
        else:
            continue
        weights.append(w)
    return problems, weights, harvested


def incremental_retune(
    deployment: Deployment,
    snapshot: TelemetrySnapshot,
    *,
    family: str = "matmul",
    report: DriftReport | None = None,
    threshold: float = DEFAULT_DRIFT_THRESHOLD,
    min_events: int = DEFAULT_MIN_EVENTS,
    n_kernels: int | None = None,
    blend: float = 0.5,
    normalization: str = "standard",
    seed: int = 0,
    dataset_builder=None,
) -> RetuneResult:
    """Refresh one family of a deployment against observed traffic, cheaply.

    Incremental in three ways against a full tune: the benchmark set is one
    representative problem per training bucket plus the live problems of
    drifted buckets only; clustering warm-starts from the deployed
    centroids; the classifier refit is traffic-weighted.  Only ``family``'s
    ``(configs, tree)`` and provenance change.  ``blend`` sets the live-vs-
    train mix of the target distribution.  ``dataset_builder(problems,
    device) -> TuningDataset`` supplies the matmul table (default: the H100
    model, which raises for a device it does not model); other families take
    their ``model_matrix`` (the H100 model), else their ``perf_matrix``.
    """
    if report is None:
        report = detect_drift(snapshot, deployment, family=family, threshold=threshold, min_events=min_events)
    train = _dist_buckets(_deployment_distribution(deployment, family))
    live = snapshot.histogram(family)
    live_problems = snapshot.family_problems.get(family, {})
    problems, weights, harvested = _blend_problems(train, live, live_problems, set(report.drifted_buckets), blend)
    if not problems:
        raise ValueError("incremental_retune needs telemetry or provenance problems")
    w = np.asarray(weights, dtype=np.float64)

    if family == "matmul":
        build = dataset_builder or _model_dataset_builder
        ds = build(problems, deployment.device)
        all_configs, perf, feats = ds.configs, ds.perf, ds.features
        dist_problems = ds.problems
    else:
        fam = get_family(family)
        all_configs = list(fam.config_space())
        model_device = deployment.device if fam.device_sensitive else None
        source = fam.model_matrix or fam.perf_matrix
        perf = source(problems, all_configs, model_device)
        feats = fam.features(problems)
        dist_problems = problems

    norm = normalize(perf, normalization)
    deployed, _tree = deployment.family_tuning(family)
    k = n_kernels or len(deployed) or get_family(family).default_n_kernels
    k = min(k, len(all_configs))
    centers = _warm_start_centers(norm, all_configs, perf, deployed)
    chosen = select_configs(norm, k, "kmeans", seed=seed, init_centers=centers)

    labels = build_labels(perf, chosen)
    if family == "matmul":
        clf = make_classifier(deployment.classifier_name, seed=seed)
    else:
        clf = get_family(family).make_tree(seed)
    fit_weighted(clf, feats, labels, w)

    new_dep = deployment.clone()
    new_dep.set_family_tuning(family, [all_configs[i] for i in chosen], clf)
    new_dist = train_distribution(dist_problems, w)
    if family == "matmul":
        new_dep.meta["train_distribution"] = new_dist
    else:
        dists = dict(new_dep.meta.get("family_distributions") or {})
        dists[family] = new_dist
        new_dep.meta["family_distributions"] = dists
    new_dep.meta["retune_count"] = int(new_dep.meta.get("retune_count", 0)) + 1
    record = {
        "family": family,
        "drift_score": round(report.score, 6),
        "unseen_fraction": round(report.unseen_fraction, 6),
        "n_harvested_buckets": harvested,
        "n_problems": len(problems),
        "warm_started": centers is not None,
    }
    new_dep.meta["retune"] = record  # the latest retune
    # One retune cycle may refresh several families (engine.maybe_retune
    # chains calls); each record survives in a bounded audit trail.
    new_dep.meta["retune_log"] = (list(new_dep.meta.get("retune_log") or []) + [record])[-16:]
    return RetuneResult(deployment=new_dep, report=report, n_harvested=harvested, n_problems=len(problems),
                        warm_started=centers is not None, family=family)


def _model_dataset_builder(problems: list[tuple], device: str) -> TuningDataset:
    from .perfmodel import DEVICES

    if device not in DEVICES:
        raise ValueError(
            f"no H100 model for device {device!r}; pass dataset_builder= "
            f"(e.g. a gpubench- or cpubench-backed measurer) to incremental_retune"
        )
    return build_model_dataset(problems, device_name=device)


# ---------------------------------------------------------------------------
# canary: validate a retune candidate before it is installed
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CanaryReport:
    """Verdict on one retune candidate for one family.

    ``selection_score_*`` are traffic-weighted achieved-fraction scores on
    the holdout (1.0 = every holdout problem gets its best deployable
    config); ``None`` when the model does not cover the device, in which
    case the selection check abstains (passes).  ``numeric_ok`` is the
    probe's agreement with the plain version.  ``ok`` is the verdict.
    """

    family: str
    ok: bool
    selection_ok: bool
    numeric_ok: bool
    selection_score_new: float | None = None
    selection_score_old: float | None = None
    reason: str = ""


def _holdout_problems(snapshot: TelemetrySnapshot, family: str, holdout: int) -> tuple[list[tuple], list[float]]:
    """The ``holdout`` heaviest-traffic buckets' representative problems."""
    live = snapshot.histogram(family)
    probs = snapshot.family_problems.get(family, {})
    buckets = sorted(live, key=lambda b: -live[b])[: max(int(holdout), 1)]
    pairs = [(probs[b], live[b]) for b in buckets if b in probs]
    return [p for p, _ in pairs], [w for _, w in pairs]


def _selection_score(deployment: Deployment, family: str, problems: list[tuple],
                     weights: list[float]) -> float | None:
    """Traffic-weighted achieved fraction of the best deployable config, on
    the H100 model; ``None`` when the model does not cover the device."""
    from .perfmodel import DEVICES

    fam = get_family(family)
    if fam.model_matrix is None or (fam.device_sensitive and deployment.device not in DEVICES):
        return None
    configs = list(fam.config_space())
    model_device = deployment.device if fam.device_sensitive else None
    perf = np.asarray(fam.model_matrix(problems, configs, model_device))
    best = perf.max(axis=1)
    total = sum(weights) or 1.0
    score = 0.0
    for i, p in enumerate(problems):
        cfg = deployment.select(family, p)
        try:
            j = configs.index(cfg)
        except ValueError:
            j = None
        achieved = float(perf[i, j]) if j is not None else 0.0
        score += weights[i] * (achieved / best[i] if best[i] > 0 else 0.0)
    return score / total


def _probe_matmul(torch, config, cuda: bool, problem, gen):
    """(got, expect, rtol, atol) pairs: the reference's f32 8x16 @ 16x8 probe,
    and on the card also the candidate's config at the served problem in bf16."""
    from ..kernels.matmul import matmul_cuda, matmul_plain

    a = torch.randn((8, 16), generator=gen)
    b = torch.randn((16, 8), generator=gen)
    expect = matmul_plain(a, b)
    if not cuda:
        return [(matmul_plain(a, b), expect, 1e-3, 1e-3)]
    out = [(matmul_cuda(a.cuda(), b.cuda(), config).cpu(), expect, 1e-3, 1e-3)]
    if problem is not None:
        m, k, n, batch = problem
        card = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((m * batch, k), generator=card, device="cuda", dtype=torch.bfloat16)
        w = torch.randn((k, n), generator=card, device="cuda", dtype=torch.bfloat16)
        want = matmul_plain(x, w).float()
        tol = 1e-2 * float(want.abs().max())
        out.append((matmul_cuda(x, w, config).float(), want, 0.0, tol))
    return out


def _numeric_agreement(family: str, config, runtime, *, device: str = "cpu",
                       problem: tuple | None = None) -> tuple[bool, str]:
    """A small probe through the family's kernel at ``config`` against the plain version.

    Seeded inputs.  The probe honors the runtime's ``canary.<family>``
    injection site (an injected failure rejects the candidate; the dispatch
    guard is not in the loop, so containment cannot mask a canary failure)
    and detaches the plan around the kernel call itself.  On the card
    (``device="cuda"``) matmul runs ``matmul_cuda`` (the reference's f32 8 x
    16 @ 16 x 8, and ``problem``, the heaviest live bucket's GEMM, in bf16
    within 1e-2 of max |plain|) and attention ``attention_cuda`` (f32 (8,
    64): the kernel's smallest head dim; the reference probes d = 16).
    Elsewhere, and for wkv and ssm_scan everywhere, the plain versions run.
    """
    import torch

    from ..kernels import ref
    from ..kernels.attention import attention_cuda, attention_plain

    if config is None:
        return True, ""
    plan = getattr(runtime, "fault_plan", None) if runtime is not None else None
    key = config.name() if hasattr(config, "name") and callable(config.name) else str(config)
    spec = None
    if plan is not None:
        from .faults import FaultError

        try:
            spec = plan.raise_if(f"canary.{family}", key)
        except FaultError as e:
            return False, f"canary probe failed: {e}"
    cuda = device == "cuda"
    gen = torch.Generator().manual_seed(0)
    f32 = lambda *shape: torch.randn(shape, generator=gen)
    if runtime is not None:
        runtime.fault_plan = None
    try:
        if family == "matmul":
            pairs = _probe_matmul(torch, config, cuda, problem, gen)
        elif family == "attention":
            d = 64 if cuda else 16
            q, k, v = f32(8, d), f32(8, d), f32(8, d)
            expect = attention_plain(q, k, v)
            got = attention_cuda(q.cuda(), k.cuda(), v.cuda(), config).cpu() if cuda else expect
            pairs = [(got, expect, 1e-3, 1e-3)]
        elif family == "wkv":
            r, k, v, logw = f32(1, 8, 1, 4), f32(1, 8, 1, 4), f32(1, 8, 1, 4), f32(1, 8, 1, 4)
            u = f32(1, 4)
            expect = ref.wkv_ref(r, k, v, -logw.abs(), u)[0]
            pairs = [(expect, expect, 1e-3, 1e-3)]  # the reference probes its oracle against itself
        elif family == "ssm_scan":
            dtx, dta = f32(1, 8, 4), f32(1, 8, 4, 2)
            b_in, c_in = f32(1, 8, 2), f32(1, 8, 2)
            expect = ref.ssm_scan_ref(dtx, -dta.abs(), b_in, c_in)[0]
            pairs = [(expect, expect, 1e-3, 1e-3)]  # as the reference's probe
        else:
            return True, ""
    except Exception as e:  # a real build or launch failure of this config
        return False, f"canary probe raised: {type(e).__name__}: {e}"
    finally:
        if runtime is not None:
            runtime.fault_plan = plan
    if spec is not None and spec.kind in ("nan", "inf"):
        from .faults import FaultPlan

        pairs = [(FaultPlan.corrupt_array(spec, got), expect, rtol, atol) for got, expect, rtol, atol in pairs]
    for got, expect, rtol, atol in pairs:
        got, expect = got.float().cpu(), expect.float().cpu()
        if not bool(torch.isfinite(got).all()):
            return False, "canary probe produced non-finite output"
        if not torch.allclose(got, expect, rtol=rtol, atol=atol):
            return False, "canary probe disagrees with reference"
    return True, ""


def canary_deployment(
    old: Deployment,
    new: Deployment,
    snapshot: TelemetrySnapshot,
    *,
    family: str = "matmul",
    holdout: int = 8,
    tolerance: float = 0.05,
    runtime=None,
    device: str = "cpu",
) -> CanaryReport:
    """Gate a retune candidate on a holdout of recent telemetry.

    Two checks, both of which must pass before ``install_for_device``:

      * **selection quality**: on the ``holdout`` heaviest live buckets, the
        candidate's traffic-weighted achieved fraction (on the H100 model)
        must not fall more than ``tolerance`` below the incumbent's;
        abstains when the model does not cover the device;
      * **numeric agreement**: the config the candidate selects for the
        heaviest bucket must reproduce the plain version on a seeded probe,
        through the kernel on the card when ``device`` is ``"cuda"``;
        honors the ``canary.<family>`` injection site.
    """
    problems, weights = _holdout_problems(snapshot, family, holdout)
    if not problems:
        return CanaryReport(family, True, True, True, reason="no holdout traffic")
    s_new = _selection_score(new, family, problems, weights)
    s_old = _selection_score(old, family, problems, weights)
    selection_ok = True
    reason = ""
    if s_new is not None and s_old is not None and s_new < s_old - tolerance:
        selection_ok = False
        reason = f"selection quality regressed: {s_new:.4f} < {s_old:.4f} - {tolerance}"
    probe_cfg = new.select(family, problems[0])
    numeric_ok, num_reason = _numeric_agreement(family, probe_cfg, runtime, device=device,
                                                problem=problems[0] if family == "matmul" else None)
    ok = selection_ok and numeric_ok
    return CanaryReport(family, ok, selection_ok, numeric_ok, s_new, s_old, reason or num_reason)
