"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100) — the library facade.

A package of its own beside the JAX reference: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Module names follow the reference so
each counterpart is easy to find.  Entry points run on ``cuda`` unless the
caller asks for ``cpu``.

The tune -> deploy -> serve lifecycle, on the card::

    import repro_torch

    bundle = repro_torch.tune(["rwkv6-7b", "hymba-1.5b"])   # this card + host_cpu
    bundle.save("build/bundle_h100.json")
    rt = repro_torch.load_bundle("build/bundle_h100.json").runtime()
    engine = rt.serve(model, params)                         # CUDA graphs on the card
    router = bundle.router(model, params, block_size=16)     # one engine per device entry

Training, on the card (every GEMM's gradient is two more GEMMs through the
same hand-written kernel, selected by the same tuned tree)::

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    cfg = registry.get("granite-8b").reduced()
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32)
    trainer = repro_torch.Trainer(model, cfg, repro_torch.DataConfig(global_batch=8),
                                  repro_torch.AdamWConfig(), repro_torch.TrainerConfig(total_steps=100))
    step, params, opt_state, metrics = trainer.train()   # auto-resumes from its checkpoints

Fleet-wide, a :class:`ControlPlane` runs tune jobs, versions their bundles
(``repro_torch.load_bundle("registry://host:port/default")``), federates
telemetry and pushes retuned versions to a :class:`PolicySubscriber`.

Submodule imports stay lazy (PEP 562): ``import repro_torch`` pulls in
neither torch nor the tuning stack until an attribute is touched.
"""
from __future__ import annotations

__version__ = "0.7.0"

__all__ = [
    "ArtifactRegistry",
    "ControlPlane",
    "ControlPlaneClient",
    "Deployment",
    "DeploymentBundle",
    "EngineStatus",
    "FaultPlan",
    "KernelRuntime",
    "PolicySubscriber",
    "Request",
    "Router",
    "ServingEngine",
    "TelemetrySnapshot",
    "Ticket",
    "__version__",
    "current_runtime",
    "default_runtime",
    "install_bundle",
    "load_bundle",
    "tune",
]

# name -> (module, attribute): resolved on first access, cached in globals().
_LAZY = {
    "ArtifactRegistry": ("repro_torch.control.registry", "ArtifactRegistry"),
    "ControlPlane": ("repro_torch.control.service", "ControlPlane"),
    "ControlPlaneClient": ("repro_torch.control.client", "ControlPlaneClient"),
    "Deployment": ("repro_torch.core.dispatch", "Deployment"),
    "DeploymentBundle": ("repro_torch.core.bundle", "DeploymentBundle"),
    "KernelRuntime": ("repro_torch.core.runtime", "KernelRuntime"),
    "EngineStatus": ("repro_torch.serve.engine", "EngineStatus"),
    "FaultPlan": ("repro_torch.core.faults", "FaultPlan"),
    "PolicySubscriber": ("repro_torch.control.client", "PolicySubscriber"),
    "Request": ("repro_torch.serve.engine", "Request"),
    "Router": ("repro_torch.serve.router", "Router"),
    # Reachable from the facade, as from repro_torch.serve and the training
    # modules; not in __all__, which keeps the reference's names.
    "Objective": ("repro_torch.core.runtime", "Objective"),
    "AdamWConfig": ("repro_torch.optim.adamw", "AdamWConfig"),
    "CheckpointManager": ("repro_torch.ckpt.checkpoint", "CheckpointManager"),
    "DataConfig": ("repro_torch.data.pipeline", "DataConfig"),
    "TokenPipeline": ("repro_torch.data.pipeline", "TokenPipeline"),
    "Trainer": ("repro_torch.train.trainer", "Trainer"),
    "TrainerConfig": ("repro_torch.train.trainer", "TrainerConfig"),
    "make_train_step": ("repro_torch.train.train_step", "make_train_step"),
    "ServingEngine": ("repro_torch.serve.engine", "ServingEngine"),
    "Ticket": ("repro_torch.serve.engine", "Ticket"),
    "TelemetrySnapshot": ("repro_torch.core.retune", "TelemetrySnapshot"),
    "current_runtime": ("repro_torch.core.runtime", "current_runtime"),
    "default_runtime": ("repro_torch.core.runtime", "default_runtime"),
    "install_bundle": ("repro_torch.core.bundle", "install_bundle"),
}


def tune(archs=None, *, devices=None, n_kernels: int = 8, families=None, **kwargs):
    """Tune every device and kernel family into one deployable bundle.

    ``archs`` scopes the benchmark harvest to the architectures you will
    launch (None = all registered); ``devices`` names the fleet (default:
    this card and ``host_cpu``; the card is measured with the port's
    kernels, ``host_cpu`` with numpy).  Returns a
    :class:`~repro_torch.core.bundle.DeploymentBundle`; remaining keyword
    arguments pass through to :func:`repro_torch.core.tuner.tune_fleet`
    (``max_problems``, ``cpu_problems``, ``prune_ratio``, ...).
    """
    from repro_torch.core.tuner import tune_fleet

    fleet = tune_fleet(
        list(archs) if archs is not None else None,
        device_names=tuple(devices) if devices is not None else None,
        n_kernels=n_kernels, families=families, **kwargs,
    )
    return fleet.bundle


def load_bundle(path):
    """Load a saved :class:`~repro_torch.core.bundle.DeploymentBundle` (any
    blob version, v1-v6); ``load_bundle(path).runtime()`` is the serving
    host's bring-up path.  ``path`` may also be a control-plane registry URI
    (``registry://host:port/name[/version]``) or a plain ``http(s)://`` URL:
    the artifact is fetched from a running
    :class:`repro_torch.control.ControlPlane`."""
    from repro_torch.core.bundle import DeploymentBundle

    return DeploymentBundle.load(path)


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
