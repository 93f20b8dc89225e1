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

Submodule imports stay lazy (PEP 562): ``import repro_torch`` pulls in
neither torch nor the tuning stack until an attribute is touched.
"""
from __future__ import annotations

__version__ = "0.7.0"

__all__ = [
    "Deployment",
    "DeploymentBundle",
    "EngineStatus",
    "KernelRuntime",
    "Request",
    "ServingEngine",
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
    "Deployment": ("repro_torch.core.dispatch", "Deployment"),
    "DeploymentBundle": ("repro_torch.core.bundle", "DeploymentBundle"),
    "KernelRuntime": ("repro_torch.core.runtime", "KernelRuntime"),
    "EngineStatus": ("repro_torch.serve.engine", "EngineStatus"),
    "Request": ("repro_torch.serve.engine", "Request"),
    "ServingEngine": ("repro_torch.serve.engine", "ServingEngine"),
    "Ticket": ("repro_torch.serve.engine", "Ticket"),
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
    host's bring-up path."""
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
