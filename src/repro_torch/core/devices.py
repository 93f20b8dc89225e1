"""Canonical device names: the label a benchmark table and a Deployment carry.

Copied from ``repro/core/devices.py`` (``canonical_device_name`` and
``_slug``, GPU branch included): the H100 this port targets reports
``torch.cuda.get_device_name()`` = ``"NVIDIA H100 80GB HBM3"``, which
becomes ``gpu_nvidia_h100_80gb_hbm3``.  Detection, the fallback chains and
``resolve_device`` join with bundles.
"""
from __future__ import annotations

import re

_TPU_KIND = re.compile(r"tpu[\s_-]*v(\d+)[\s_-]*(lite|e|p|i)?", re.IGNORECASE)


def _slug(s: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", s.strip().lower()).strip("_") or "unknown"


def canonical_device_name(kind: str, platform: str | None = None) -> str:
    """Normalize a ``device_kind`` / platform pair to a canonical slug.

    ``"TPU v5 lite"`` -> ``tpu_v5e``; ``"TPU v4"`` / ``"TPU v4i"`` ->
    ``tpu_v4``; ``"cpu"`` -> ``host_cpu``; GPUs become ``gpu_<kind>``;
    already-canonical slugs pass through unchanged.
    """
    raw = (kind or platform or "").strip()
    low = raw.lower()
    if low in ("cpu", "host_cpu") or platform == "cpu":
        return "host_cpu"
    m = _TPU_KIND.search(low)
    if m:
        version, variant = m.group(1), (m.group(2) or "").lower()
        if variant == "lite":
            variant = "e"
        elif variant == "i":  # inference variants tune like the base part
            variant = ""
        return f"tpu_v{version}{variant}"
    if platform == "gpu" or low.startswith("gpu"):
        return "gpu_" + _slug(re.sub(r"^gpu[\s_-]*", "", low) or "unknown")
    return _slug(raw)
