"""Device registry + detection: the "which tuned artifact runs here?" layer.

Copied from ``repro/core/devices.py``: canonical device names, the
``REPRO_DEVICE`` override, the nearest-device fallback chains and
``resolve_device`` (DESIGN.md §7).  The port detects the card through
``torch.cuda.get_device_name`` (the H100 this port targets reports
``"NVIDIA H100 80GB HBM3"``, which becomes ``gpu_nvidia_h100_80gb_hbm3``);
with no CUDA device the host is ``host_cpu``.  :data:`FALLBACKS` keeps the
reference's entries, which name no GPU: a card resolves through the
same-platform and any-tuned steps of :func:`resolve_device`.

One difference from the reference: a kind that starts with ``NVIDIA`` is
canonicalized as a GPU even without ``platform="gpu"``, so
``REPRO_DEVICE="NVIDIA H100 80GB HBM3"`` names the same entry detection
does (the reference slugs it to ``nvidia_h100_80gb_hbm3``, a platform of
its own).
"""
from __future__ import annotations

import os
import re

DEVICE_ENV_VAR = "REPRO_DEVICE"

# Preference chain per canonical device: first tuned entry wins.  Chains are
# walked in order and only ever consulted when the device itself is untuned.
FALLBACKS: dict[str, tuple[str, ...]] = {
    "tpu_v6e": ("tpu_v5e", "tpu_v5p", "tpu_v4"),
    "tpu_v5p": ("tpu_v4", "tpu_v5e"),
    "tpu_v5e": ("tpu_v4", "tpu_v6e"),
    "tpu_v4": ("tpu_v5e", "tpu_v5p"),
    "tpu_v3": ("tpu_v4", "tpu_v5e"),
    "tpu_v2": ("tpu_v3", "tpu_v4", "tpu_v5e"),
    "host_cpu": (),
}

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
    if platform == "gpu" or low.startswith(("gpu", "nvidia")):
        return "gpu_" + _slug(re.sub(r"^gpu[\s_-]*", "", low) or "unknown")
    return _slug(raw)


def detect_device(env: dict | None = None) -> str:
    """Canonical name of the host accelerator (env override > torch probe).

    ``REPRO_DEVICE`` wins when set (itself canonicalized, so both
    ``REPRO_DEVICE=tpu_v4`` and ``REPRO_DEVICE="TPU v4"`` work).  Otherwise
    the first CUDA device's name (``torch.cuda.get_device_name(0)``) is
    normalized as a GPU; a host where torch finds no CUDA device reports
    ``host_cpu``.
    """
    e = env if env is not None else os.environ
    override = e.get(DEVICE_ENV_VAR)
    if override:
        return canonical_device_name(override)
    import torch

    if not torch.cuda.is_available():
        return "host_cpu"
    return canonical_device_name(torch.cuda.get_device_name(0), "gpu")


def _family(name: str) -> str:
    return name.split("_", 1)[0]


def fallback_order(device: str) -> list[str]:
    """Every sibling reachable from ``device`` through :data:`FALLBACKS`,
    nearest first (breadth-first over the preference graph).

    The direct chain comes first in its declared order, then each entry's own
    chain, and so on transitively — so a v2 host with only a v5p artifact
    still finds it (v2 -> v3 -> v4 -> v5p) instead of dropping straight to
    the same-platform-family lottery.  Cycle-safe: the graph is deliberately
    cyclic (v5e <-> v4) and every device is visited at most once; ``device``
    itself never appears in its own order.
    """
    device = canonical_device_name(device)
    seen = {device}
    order: list[str] = []
    frontier = [device]
    while frontier:
        nxt: list[str] = []
        for d in frontier:
            for cand in FALLBACKS.get(d, ()):
                if cand in seen:
                    continue
                seen.add(cand)
                order.append(cand)
                nxt.append(cand)
        frontier = nxt
    return order


def transfer_donor(device: str, tuned: "list[str] | set[str]") -> str | None:
    """The nearest already-tuned sibling a new device can warm-start from.

    Walks :func:`fallback_order` (so multi-hop siblings count), then any
    tuned device of the same platform family.  Never crosses platform
    families — a ``host_cpu`` tuning says nothing about a TPU's perf surface,
    so unlike :func:`resolve_device` there is no serve-anything last resort.
    """
    device = canonical_device_name(device)
    tuned_set = {canonical_device_name(t) for t in tuned} - {device}
    for cand in fallback_order(device):
        if cand in tuned_set:
            return cand
    fam = _family(device)
    for cand in sorted(tuned_set):
        if _family(cand) == fam:
            return cand
    return None


def transfer_order(device_names: "list[str] | tuple[str, ...]") -> list[str]:
    """Order a fleet so donors tune before the siblings that warm-start off
    them (deterministic for a given input order).

    Greedy: at each step prefer a device whose :func:`transfer_donor` is
    already placed; when none qualifies (the bootstrap full-tune roots),
    place the device that donates to the most still-pending peers, earliest
    in the input on ties.  Duplicates (post-canonicalization) collapse to
    their first occurrence.
    """
    pending = list(dict.fromkeys(canonical_device_name(n) for n in device_names))
    placed: list[str] = []
    while pending:
        pick = next((d for d in pending if transfer_donor(d, placed)), None)
        if pick is None:
            def donates(d: str) -> int:
                return sum(1 for o in pending if o != d and d in fallback_order(o))

            pick = max(pending, key=lambda d: (donates(d), -pending.index(d)))
        placed.append(pick)
        pending.remove(pick)
    return placed


def resolve_device(
    requested: str, available: list[str], *, strict: bool = False
) -> str | None:
    """Pick the tuned device that should serve ``requested``.

    Resolution order (DESIGN.md §7):
      1. exact match;
      2. the :data:`FALLBACKS` graph for ``requested`` — the direct chain in
         order, then transitive siblings breadth-first (:func:`fallback_order`);
      3. any available device of the same platform family (``tpu_*`` for a
         TPU, ...), lexicographically smallest for determinism;
      4. non-strict only: any available device at all (a tuned artifact still
         beats the untuned ``FixedPolicy`` baseline).

    Returns ``None`` (or raises ``KeyError`` when ``strict``) if nothing is
    available.
    """
    requested = canonical_device_name(requested)
    avail = sorted(dict.fromkeys(available))
    if requested in avail:
        return requested
    for cand in fallback_order(requested):
        if cand in avail:
            return cand
    fam = _family(requested)
    for cand in avail:
        if _family(cand) == fam:
            return cand
    if not strict and avail:
        return avail[0]
    if strict:
        raise KeyError(
            f"no deployment resolves device {requested!r} (available: {avail})"
        )
    return None
