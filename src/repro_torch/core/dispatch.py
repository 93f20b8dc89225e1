"""Deployment artifact: selected kernels + trained runtime classifier (paper §5).

A :class:`Deployment` is what actually ships in the library: per kernel
*family* (``core.families``), the list of deployed kernel configs (the
'binary blobs') and a classifier mapping problem features -> deployed-config
index.  It implements the ``KernelPolicy`` protocol consumed by
``kernels.ops``: the generic :meth:`Deployment.select` answers any
registered family, with ``select_matmul`` / ``select_attention`` /
``select_wkv`` / ``select_ssm`` kept as thin shims.  ``rt.install(dep)``
puts it in a ``KernelRuntime``, as any policy.

Blob format (DESIGN.md §9): the port writes v5, flat trees plus a
``families`` section carrying every family beyond the legacy
matmul/attention fields; unknown family names in a newer blob are ignored
on load (forward compat).

Ported from ``repro/core/dispatch.py``: ``from_blob`` rebuilds the port's
config classes, whose fields are the reference's, so a blob of the
reference's TPU configs loads (``core/bundle.py`` reads the reference's
fixtures); its configs are selections only, and installing them for a CUDA
target raises (``KernelRuntime.install_bundle``).  Under a serving
objective (``core/runtime.py::Objective``) the runtime routes selection
through :meth:`Deployment.select_for_objective`, which ranks the family's
deployed configs on the port's own family model (``model_matrix``, the H100
model) for the one problem.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..kernels.attention import DEFAULT_ATTN_CONFIG, AttentionConfig
from ..kernels.matmul import MatmulConfig

from .classify import make_classifier
from .dataset import TuningDataset, problem_features
from .families import FamilyTuning, get_family, is_registered

DEPLOYMENT_VERSION = 5


def _validate_tree_labels(tree, n_configs: int, field: str) -> None:
    """Reject blobs whose leaves point past the deployed config list.

    A corrupt / truncated artifact used to be clamped silently at dispatch
    time; failing at ``load`` surfaces it where it can actually be fixed.
    """
    flat = tree._ensure_flat()
    hi = flat.max_leaf_label()
    lo = int(flat.label.min())
    if lo < 0 or hi >= n_configs:
        raise ValueError(
            f"deployment blob {field!r} selects config {hi if hi >= n_configs else lo} "
            f"but only {n_configs} configs are deployed"
        )


def build_labels(perf: np.ndarray, chosen: list[int]) -> np.ndarray:
    """Per-problem index (into ``chosen``) of the best deployed kernel."""
    perf = np.asarray(perf, dtype=np.float64)
    return perf[:, chosen].argmax(axis=1)


@dataclasses.dataclass
class Deployment:
    """The shippable tuning artifact (implements KernelPolicy).

    The matmul family lives in the legacy ``configs``/``classifier`` fields
    and attention in ``attention_configs``/``attention_tree`` (wire + ctor
    compatibility); every other family lives in ``families``.  Use
    :meth:`family_tuning` / :meth:`set_family_tuning` for uniform access.
    """

    # Selections are a pure function of the problem shape, so the ops-layer
    # shape cache may memoize them (DESIGN.md §6).
    cacheable = True

    device: str
    configs: list[MatmulConfig]
    classifier: object  # fit classifier: features -> index into configs
    classifier_name: str = "DecisionTreeA"
    attention_configs: list[AttentionConfig] = dataclasses.field(
        default_factory=lambda: [DEFAULT_ATTN_CONFIG]
    )
    attention_tree: object | None = None  # features -> index into attention_configs
    meta: dict = dataclasses.field(default_factory=dict)
    families: dict[str, FamilyTuning] = dataclasses.field(default_factory=dict)

    # -- family access ------------------------------------------------------
    def family_tuning(self, family: str) -> FamilyTuning:
        """``(configs, tree)`` for any family (empty tuning when untuned)."""
        if family == "matmul":
            return FamilyTuning(self.configs, self.classifier)
        if family == "attention":
            return FamilyTuning(self.attention_configs, self.attention_tree)
        return self.families.get(family, FamilyTuning([], None))

    def family_names(self) -> list[str]:
        """Families this artifact carries a non-empty tuning for."""
        out = []
        if self.configs:
            out.append("matmul")
        if self.attention_configs:
            out.append("attention")
        out.extend(sorted(self.families))
        return out

    def set_family_tuning(self, family: str, configs: list, tree: object | None) -> None:
        if family == "matmul":
            self.configs = list(configs)
            self.classifier = tree
        elif family == "attention":
            self.attention_configs = list(configs)
            self.attention_tree = tree
        else:
            self.families[family] = FamilyTuning(list(configs), tree)

    def clone(self) -> "Deployment":
        """Shallow copy safe for per-family replacement (retune's swap unit)."""
        return Deployment(
            device=self.device,
            configs=list(self.configs),
            classifier=self.classifier,
            classifier_name=self.classifier_name,
            attention_configs=list(self.attention_configs),
            attention_tree=self.attention_tree,
            meta=dict(self.meta),
            families=dict(self.families),
        )

    # -- KernelPolicy -------------------------------------------------------
    def select(self, family: str, problem: tuple):
        """Generic launcher-side selection for any registered family."""
        configs, tree = self.family_tuning(family)
        if not configs:
            return get_family(family).default_config
        if tree is None:
            if family == "attention":
                return self._attention_bucket_fallback(*problem)
            return configs[0]
        feats = get_family(family).features([tuple(problem)])
        idx = int(tree.predict(feats)[0])
        idx = min(max(idx, 0), len(configs) - 1)
        return configs[idx]

    def select_matmul(self, m: int, k: int, n: int, batch: int) -> MatmulConfig:
        feats = problem_features([(m, k, n, batch)])
        idx = int(self.classifier.predict(feats)[0])
        idx = min(max(idx, 0), len(self.configs) - 1)
        return self.configs[idx]

    def select_attention(self, sq: int, skv: int, d: int) -> AttentionConfig:
        if self.attention_tree is not None:
            return self.select("attention", (sq, skv, d))
        return self._attention_bucket_fallback(sq, skv, d)

    def select_wkv(self, s: int, hd: int):
        return self.select("wkv", (s, hd))

    def select_ssm(self, s: int, d: int):
        return self.select("ssm_scan", (s, d))

    def select_for_objective(self, family: str, problem: tuple, objective):
        """SLO-aware selection: pick by predicted per-problem speed.

        The classifier maximises aggregate throughput over the training
        distribution; under a latency objective the serving tier wants the
        config the family's model predicts *fastest for this problem* (max
        score).  Falls back to the plain path where the reference does: the
        objective carries no target, the family has nothing to choose
        between, it declares no model, or the model fails.
        """
        if getattr(objective, "latency_target_ms", None) is None:
            return self.select(family, tuple(problem))
        configs, _tree = self.family_tuning(family)
        if len(configs) <= 1:
            return self.select(family, tuple(problem))
        fam = get_family(family)
        model = fam.model_matrix or fam.perf_matrix
        if model is None:
            return self.select(family, tuple(problem))
        try:
            scores = np.asarray(model([tuple(problem)], list(configs), self.device))
        except Exception:
            return self.select(family, tuple(problem))
        return configs[int(np.argmax(scores[0]))]

    def _attention_bucket_fallback(self, sq: int, skv: int, d: int) -> AttentionConfig:
        # Pick by KV-length bucket (untuned deployments).
        best = self.attention_configs[0]
        for cfg in self.attention_configs:
            if cfg.block_kv <= max(skv, 128) and cfg.block_q <= max(sq, 128):
                if cfg.block_kv * cfg.block_q > best.block_kv * best.block_q:
                    best = cfg
        return best

    # -- persistence ---------------------------------------------------------
    def to_blob(self) -> dict:
        """JSON-ready v5 blob: v2 structure-of-arrays tree blobs plus a
        ``families`` section for every family beyond matmul/attention."""
        from .codegen import tree_to_flat_dict

        return {
            "version": DEPLOYMENT_VERSION,
            "device": self.device,
            "configs": [c.to_dict() for c in self.configs],
            "attention_configs": [c.to_dict() for c in self.attention_configs],
            "classifier_name": self.classifier_name,
            "tree": tree_to_flat_dict(self.classifier),
            "attention_tree": (
                tree_to_flat_dict(self.attention_tree) if self.attention_tree is not None else None
            ),
            "meta": self.meta,
            "families": {
                name: {
                    "configs": [c.to_dict() for c in tuning.configs],
                    "tree": tree_to_flat_dict(tuning.tree) if tuning.tree is not None else None,
                }
                for name, tuning in sorted(self.families.items())
            },
        }

    def save(self, path: str | Path) -> None:
        """Serialize (decision-tree classifiers only, like the paper ships)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_blob(), indent=1))

    @staticmethod
    def from_blob(blob: dict) -> "Deployment":
        """Parse a single-device blob (label-validated on the way in).

        Unknown family names inside a v5 ``families`` section are skipped —
        a newer artifact stays loadable, serving the families this build
        knows (the unknown op falls back to its reference implementation).
        """
        from .codegen import dict_to_tree

        atree = blob.get("attention_tree")
        extra: dict[str, FamilyTuning] = {}
        for name, sub in (blob.get("families") or {}).items():
            if name in ("matmul", "attention") or not is_registered(name):
                continue  # legacy fields win; unknown families are ignored
            fam = get_family(name)
            cfgs = [fam.config_cls.from_dict(d) for d in sub.get("configs", [])]
            tree = dict_to_tree(sub["tree"]) if sub.get("tree") else None
            extra[name] = FamilyTuning(cfgs, tree)
        dep = Deployment(
            device=blob["device"],
            configs=[MatmulConfig.from_dict(d) for d in blob["configs"]],
            classifier=dict_to_tree(blob["tree"]),
            classifier_name=blob["classifier_name"],
            attention_configs=[AttentionConfig.from_dict(d) for d in blob["attention_configs"]],
            attention_tree=dict_to_tree(atree) if atree else None,
            meta=blob.get("meta", {}),
            families=extra,
        )
        _validate_tree_labels(dep.classifier, len(dep.configs), "tree")
        if dep.attention_tree is not None:
            _validate_tree_labels(
                dep.attention_tree, len(dep.attention_configs), "attention_tree"
            )
        for name, tuning in dep.families.items():
            if tuning.tree is not None:
                _validate_tree_labels(tuning.tree, len(tuning.configs), f"families.{name}.tree")
        return dep

    @staticmethod
    def load(path: str | Path) -> "Deployment":
        return Deployment.from_blob(json.loads(Path(path).read_text()))


def train_deployment(
    train: TuningDataset,
    chosen: list[int],
    classifier_name: str = "DecisionTreeA",
    *,
    meta: dict | None = None,
    seed: int = 0,
) -> Deployment:
    labels = build_labels(train.perf, chosen)
    clf = make_classifier(classifier_name, seed=seed)
    clf.fit(train.features, labels)
    return Deployment(
        device=train.device,
        configs=[train.configs[i] for i in chosen],
        classifier=clf,
        classifier_name=classifier_name,
        meta=meta or {},
    )


def classifier_fraction(test: TuningDataset, chosen: list[int], deployment: Deployment) -> float:
    """Geomean of (perf of classifier-picked kernel) / optimal (Tables 1-2)."""
    from .selection import geomean_fraction

    pred = deployment.classifier.predict(test.features)
    pred = np.clip(pred, 0, len(chosen) - 1)
    picked = test.perf[np.arange(len(test.problems)), [chosen[i] for i in pred]]
    return geomean_fraction(picked, test.perf.max(axis=1))
