"""Kernel selection: the tuning pipeline, the measured H100 tables and the runtime.

The paper's contribution, as the reference's ``repro.core``: benchmark table
-> normalize -> cluster-select the deployable subset -> train the runtime
classifier -> ``Deployment`` artifact.  The same names are exported.  As in
the reference, ``core.families`` and ``core.normalize`` are the functions of
those names; the submodules are ``importlib.import_module("repro_torch.core.families")``.
"""
from .bundle import DeploymentBundle, install_bundle
from .classify import CLASSIFIERS, make_classifier
from .devices import canonical_device_name, detect_device, resolve_device
from .flattree import FlatTree
from .cluster import CLUSTER_METHODS, select_configs
from .dataset import TuningDataset, build_model_dataset, harvest_problems, problem_features, synthetic_problems
from .dispatch import Deployment, classifier_fraction, train_deployment
from .faults import FaultError, FaultPlan, FaultSpec
from .families import (
    FamilyTuning,
    KernelFamily,
    build_family_dataset,
    families,
    family_names,
    get_family,
    register_family,
)
from .normalize import NORMALIZATIONS, normalize
from .pca import PCA
from .pipeline import (
    FamilyPipelineResult,
    TransferPrior,
    run_family_pipeline,
    tune_dataset,
)
from .retune import TelemetrySnapshot
from .runtime import KernelRuntime, current_runtime, default_runtime, reset_default_runtime
from .selection import achievable_fraction, evaluate_methods, select_from_dataset
from .tuner import FleetTuneResult, TuneResult, save_fleet, tune, tune_family, tune_fleet, tune_for_archs

__all__ = [
    "CLASSIFIERS",
    "CLUSTER_METHODS",
    "NORMALIZATIONS",
    "PCA",
    "Deployment",
    "DeploymentBundle",
    "FamilyPipelineResult",
    "FamilyTuning",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "FlatTree",
    "FleetTuneResult",
    "KernelFamily",
    "KernelRuntime",
    "TelemetrySnapshot",
    "TransferPrior",
    "TuneResult",
    "TuningDataset",
    "achievable_fraction",
    "build_family_dataset",
    "build_model_dataset",
    "canonical_device_name",
    "classifier_fraction",
    "current_runtime",
    "default_runtime",
    "detect_device",
    "evaluate_methods",
    "families",
    "family_names",
    "get_family",
    "harvest_problems",
    "install_bundle",
    "make_classifier",
    "normalize",
    "problem_features",
    "register_family",
    "reset_default_runtime",
    "resolve_device",
    "run_family_pipeline",
    "save_fleet",
    "select_configs",
    "select_from_dataset",
    "synthetic_problems",
    "train_deployment",
    "tune",
    "tune_dataset",
    "tune_family",
    "tune_fleet",
    "tune_for_archs",
]
