"""Kernel-family registry: every tunable op as a first-class pipeline citizen.

Ported from ``repro/core/families.py``.  A :class:`KernelFamily` declares
everything the tune -> deploy -> dispatch pipeline needs to know about one
op, and every layer iterates the registry instead of special-casing
matmul/attention:

  * ``tuner.tune`` / ``tune_for_archs`` / ``tune_fleet``  tune each requested family;
  * ``dispatch.Deployment``             stores per-family ``(configs, tree)``
                                        and answers ``select(family, problem)``;
  * ``core.runtime``                    memoizes by family-qualified shape key.

Four families are registered, with the port's Hopper config spaces.  Each
takes its ``perf_matrix`` from the card (``core/gpubench.py``: every
compiled config timed on every harvested problem with the port's own
kernel) and its ``model_matrix`` from the H100 model (``core/perfmodel.py``,
``core/attnmodel.py``, ``core/recmodel.py``), the measurement-free
predictor the staged pipeline prunes, plans and fills with.

**Every family is device-sensitive here.**  The reference tunes attention,
wkv and ssm_scan once per fleet against their TPU v5e models
(``device_sensitive=False``, and its pipeline passes ``device_name=None``)
and shares the tuning across devices; the port's tables are the card's own,
so a tuning holds for the card it was measured on, and nothing is shared
across a fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np

from ..kernels import attention as _attention
from ..kernels import matmul as _matmul
from ..kernels import ssm as _ssm
from ..kernels import wkv as _wkv
from .attnmodel import ATTN_FEATURE_NAMES, attn_problem_features, harvest_attn_problems
from .dataset import FEATURE_NAMES as MATMUL_FEATURE_NAMES
from .dataset import harvest_problems, problem_features
from .recmodel import (
    SSM_FEATURE_NAMES,
    WKV_FEATURE_NAMES,
    harvest_ssm_problems,
    harvest_wkv_problems,
    ssm_problem_features,
    wkv_problem_features,
)


class FamilyTuning(NamedTuple):
    """One family's shipped artifact: deployed configs + runtime classifier."""

    configs: list
    tree: object | None


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """Everything the pipeline needs to know about one tunable op.

    ``perf_matrix(problems, configs, device_name)`` is the benchmark-data
    source; ``harvest(arch_ids)`` yields the problems the assigned
    architectures actually launch; ``features`` is the featurization shared
    by tuning and dispatch.  ``name`` doubles as the dispatch-op key.
    """

    name: str
    config_cls: type
    config_space: Callable[[], Sequence]
    default_config: object
    feature_names: tuple[str, ...]
    features: Callable[[list[tuple]], np.ndarray]
    harvest: Callable[[list[str] | None], list[tuple]]
    perf_matrix: Callable[[list[tuple], Sequence, str | None], np.ndarray]
    default_n_kernels: int = 4
    # True: the perf surface differs per device, so a tuning holds for the
    # device it was measured on.
    device_sensitive: bool = False
    # Decision-tree hyperparameters for this family's runtime classifier.
    tree_max_depth: int = 6
    tree_min_samples_leaf: int = 1
    # Measurement-free perf predictor, same signature as ``perf_matrix``: the
    # staged pipeline's prune / transfer / budget stages read it (None: the
    # family keeps its whole space and measures every cell).
    model_matrix: Callable[[list[tuple], Sequence, str | None], np.ndarray] | None = None

    def make_tree(self, seed: int = 0):
        """A fresh (unfit) runtime classifier for this family."""
        from .classify import DecisionTreeClassifier

        return DecisionTreeClassifier(
            max_depth=self.tree_max_depth, min_samples_leaf=self.tree_min_samples_leaf,
            seed=seed,
        )


_REGISTRY: dict[str, KernelFamily] = {}


def register_family(family: KernelFamily) -> KernelFamily:
    """Add (or replace) one family; returns it for decorator-style use."""
    if not family.name or any(ch in family.name for ch in " ,/"):
        raise ValueError(f"bad family name {family.name!r}")
    _REGISTRY[family.name] = family
    return family


def unregister_family(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_family(name: str) -> KernelFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel family {name!r}; registered: {family_names()}") from None


def family_names() -> list[str]:
    """Registered family names, matmul first (it anchors the Deployment)."""
    return sorted(_REGISTRY, key=lambda n: (n != "matmul", n))


def is_registered(name: str) -> bool:
    return name in _REGISTRY


# ---------------------------------------------------------------------------
# built-in families
# ---------------------------------------------------------------------------
def _measured(family: str):
    """``perf_matrix`` of a family measured on the card (``core/gpubench.py``)."""

    def perf_matrix(problems, configs, device_name):
        from .gpubench import card_name, measure

        if device_name is not None and device_name != card_name():
            raise ValueError(
                f"the {family} table is measured on this card ({card_name()}), "
                f"not on {device_name!r}"
            )
        return measure(family, list(problems), list(configs))

    return perf_matrix


def _matmul_model(problems, configs, device_name):
    from .perfmodel import build_perf_matrix

    return build_perf_matrix(problems, list(configs), device_name)


def _attn_model(problems, configs, device_name):
    from .attnmodel import build_attn_matrix

    return build_attn_matrix(problems, list(configs), device_name)


def _wkv_model(problems, configs, device_name):
    from .recmodel import build_wkv_matrix

    return build_wkv_matrix(problems, list(configs), device_name)


def _ssm_model(problems, configs, device_name):
    from .recmodel import build_ssm_matrix

    return build_ssm_matrix(problems, list(configs), device_name)


MATMUL = register_family(
    KernelFamily(
        name="matmul",
        config_cls=_matmul.MatmulConfig,
        config_space=_matmul.config_space,
        default_config=_matmul.DEFAULT_CONFIG,
        feature_names=tuple(MATMUL_FEATURE_NAMES),
        features=problem_features,
        harvest=harvest_problems,
        perf_matrix=_measured("matmul"),
        default_n_kernels=8,
        device_sensitive=True,
        model_matrix=_matmul_model,
    )
)

ATTENTION = register_family(
    KernelFamily(
        name="attention",
        config_cls=_attention.AttentionConfig,
        config_space=_attention.config_space,
        default_config=_attention.DEFAULT_ATTN_CONFIG,
        feature_names=tuple(ATTN_FEATURE_NAMES),
        features=attn_problem_features,
        harvest=harvest_attn_problems,
        perf_matrix=_measured("attention"),
        default_n_kernels=4,
        device_sensitive=True,
        model_matrix=_attn_model,
    )
)

WKV = register_family(
    KernelFamily(
        name="wkv",
        config_cls=_wkv.WkvConfig,
        config_space=_wkv.config_space,
        default_config=_wkv.DEFAULT_WKV_CONFIG,
        feature_names=tuple(WKV_FEATURE_NAMES),
        features=wkv_problem_features,
        harvest=harvest_wkv_problems,
        perf_matrix=_measured("wkv"),
        default_n_kernels=3,
        device_sensitive=True,
        model_matrix=_wkv_model,
    )
)

SSM_SCAN = register_family(
    KernelFamily(
        name="ssm_scan",
        config_cls=_ssm.SsmConfig,
        config_space=_ssm.config_space,
        default_config=_ssm.DEFAULT_SSM_CONFIG,
        feature_names=tuple(SSM_FEATURE_NAMES),
        features=ssm_problem_features,
        harvest=harvest_ssm_problems,
        perf_matrix=_measured("ssm_scan"),
        default_n_kernels=4,
        device_sensitive=True,
        model_matrix=_ssm_model,
    )
)
