"""repro_torch.control — the tuning control plane (DESIGN.md §14), ported.

Stdlib-only service + client turning the single-process tune→deploy→retune
loop fleet-wide: a job API running tunes (measured on the card) in the
background, a content-hashed versioned artifact registry with tuning
lineage, and telemetry federation that merges per-device snapshots from many
serving hosts, drift-checks the aggregate, and pushes incremental-retune
artifacts to subscribed engines and runtimes over a policy long-poll.  The
wire formats are the reference's (``repro.control``).

    from repro_torch.control import ControlPlane, ControlPlaneClient, PolicySubscriber

    with ControlPlane(port=0) as plane:
        client = ControlPlaneClient(plane.url)
        job = client.submit({"archs": ["granite-8b"]})
        client.wait_job(job["id"])
        bundle = repro_torch.load_bundle(client.registry_uri("default"))
"""
from .client import ControlPlaneClient, ControlPlaneError, PolicySubscriber
from .registry import ArtifactRegistry, ArtifactVersion, content_version
from .service import ControlPlane, Job

__all__ = [
    "ArtifactRegistry",
    "ArtifactVersion",
    "ControlPlane",
    "ControlPlaneClient",
    "ControlPlaneError",
    "Job",
    "PolicySubscriber",
    "content_version",
]
