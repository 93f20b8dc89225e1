"""Multi-device deployment bundle: one artifact, one Deployment per device.

Ported from ``repro/core/bundle.py``.  A :class:`DeploymentBundle` carries
the tuned artifacts for every target the library may land on, keyed by
canonical device name (``core/devices.py``), and routes by detected
hardware: the card's entry on the card, ``host_cpu`` on a host without
one, the nearest tuned sibling elsewhere (``devices.resolve_device``).

Format (DESIGN.md §7-§9), the reference's both ways::

    {"version": 6, "format": "bundle",
     "deployments": {"gpu_nvidia_h100_80gb_hbm3": {<v5 blob>}, "host_cpu": {<v5 blob>}},
     "provenance": {<device>: {"train_distribution": {...},
                               "family_distributions": {...},
                               "tuning_lineage": {...}}, ...},
     "checksums": {"deployments.<dev>": "<crc32>",
                   "deployments.<dev>.families.<fam>": "<crc32>", "provenance": "<crc32>"},
     "meta": {...}}

v6's ``checksums`` hold one CRC32 per section: a device blob's core
(everything but its ``families``), each family section, the provenance
block.  A corrupt family section drops only that family (its op serves the
default config), a corrupt device core drops only that device (lookups for
it recover through the fallback chain), and only a bundle with no
surviving device raises (:class:`BundleIntegrityError`); anything dropped
is recorded in ``DeploymentBundle.load_errors``.  v1-v5 artifacts load
unchanged, and a plain v1/v2/v5 single-device file loads as a one-entry
bundle.  Malformed input raises :class:`BundleFormatError` (a
``ValueError``) with the failing ``section`` and, for JSON syntax errors,
the byte ``offset``.

The port writes every device blob in the v5 flat layout.  Loading a TPU
bundle works (its configs are only selections on the CPU); installing one
for a CUDA target raises (``KernelRuntime.install_bundle``), because its
configs are not in the port's compiled space.  The reference's registry
URIs (``parse_registry_uri``, the control plane's) and ``router()``
(``serve/router.py``) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path

from .devices import canonical_device_name, resolve_device
from .dispatch import Deployment

BUNDLE_VERSION = 6

# Deployment.meta keys that form the v4+ top-level provenance block.
_PROVENANCE_KEYS = (
    "train_distribution", "family_distributions", "retune_count", "retune", "retune_log",
    "tuning_lineage",
)


class BundleError(ValueError):
    """Base of all structured bundle load/validate failures.

    Subclasses ``ValueError`` so pre-v6 callers catching ``ValueError``
    around ``DeploymentBundle.load`` keep working.
    """


class BundleFormatError(BundleError):
    """The blob is structurally unreadable (truncated, garbage, missing keys).

    ``section`` names the part of the blob being parsed when the failure hit
    (``None`` for whole-file errors); ``offset`` is the byte offset for JSON
    syntax errors (``None`` otherwise).
    """

    def __init__(self, message: str, *, section: str | None = None,
                 offset: int | None = None):
        at = []
        if section is not None:
            at.append(f"section={section!r}")
        if offset is not None:
            at.append(f"offset={offset}")
        super().__init__(f"{message} [{', '.join(at)}]" if at else message)
        self.section = section
        self.offset = offset


class BundleIntegrityError(BundleError):
    """Checksum verification left nothing servable (every device dropped)."""


def _section_checksum(obj) -> str:
    """CRC32 over the section's canonical JSON, as 8 hex chars."""
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    return f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}"


def _blob_checksums(deployments_blob: dict, provenance: dict) -> dict[str, str]:
    """The v6 ``checksums`` block for a serialized bundle.

    Keys: ``deployments.<dev>`` (device blob core, families excluded),
    ``deployments.<dev>.families.<fam>`` (one per family section), and
    ``provenance`` (the whole block).
    """
    sums: dict[str, str] = {}
    for name, sub in deployments_blob.items():
        core = {k: v for k, v in sub.items() if k != "families"}
        sums[f"deployments.{name}"] = _section_checksum(core)
        for fam, fam_blob in (sub.get("families") or {}).items():
            sums[f"deployments.{name}.families.{fam}"] = _section_checksum(fam_blob)
    if provenance:
        sums["provenance"] = _section_checksum(provenance)
    return sums


def _verify_device_blob(
    name: str, sub, sums: dict[str, str], load_errors: list[dict]
):
    """Checksum one device blob; returns the (possibly reduced) blob or None.

    A corrupt device core drops the whole device (``None`` — lookups recover
    via ``devices.FALLBACKS``); a corrupt or missing family section drops
    only that family (its op serves the reference path).  Sections without a
    checksum entry (pre-v6 blobs, hand-edited extras) are not judged.
    """
    key = f"deployments.{name}"
    if not isinstance(sub, dict):
        load_errors.append({
            "section": key, "error": f"not an object ({type(sub).__name__})",
            "action": "device dropped (FALLBACKS recovery)",
        })
        return None
    if key in sums:
        core = {k: v for k, v in sub.items() if k != "families"}
        if _section_checksum(core) != sums[key]:
            load_errors.append({
                "section": key, "error": "checksum mismatch",
                "action": "device dropped (FALLBACKS recovery)",
            })
            return None
    fams = sub.get("families")
    present = set(fams) if isinstance(fams, dict) else set()
    if isinstance(fams, dict):
        kept = {}
        for fam, fam_blob in fams.items():
            fkey = f"{key}.families.{fam}"
            if fkey in sums and _section_checksum(fam_blob) != sums[fkey]:
                load_errors.append({
                    "section": fkey, "error": "checksum mismatch",
                    "action": "family dropped (reference path)",
                })
                continue
            kept[fam] = fam_blob
        if len(kept) != len(fams):
            sub = dict(sub, families=kept)
    prefix = f"{key}.families."
    for fkey in sums:
        if fkey.startswith(prefix) and fkey[len(prefix):] not in present:
            load_errors.append({
                "section": fkey, "error": "checksummed section missing",
                "action": "family dropped (reference path)",
            })
    return sub


def _parse_deployment(sub: dict, section: str) -> Deployment:
    """``Deployment.from_blob`` with bare struct errors wrapped as format errors."""
    try:
        return Deployment.from_blob(sub)
    except BundleError:
        raise
    except (KeyError, TypeError, AttributeError, IndexError) as e:
        raise BundleFormatError(
            f"malformed deployment blob: {type(e).__name__}: {e}", section=section
        ) from e
    except ValueError as e:
        raise BundleFormatError(str(e), section=section) from e


@dataclasses.dataclass
class DeploymentBundle:
    """Versioned pack of per-device deployments (the deploy-anywhere artifact).

    ``load_errors`` records sections a v6 checksum pass dropped during load
    (empty for a clean or pre-v6 artifact) — the bundle still serves with
    whatever survived, recovering dropped devices via ``devices.FALLBACKS``.
    """

    deployments: dict[str, Deployment]
    meta: dict = dataclasses.field(default_factory=dict)
    load_errors: list[dict] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.deployments:
            raise ValueError("a DeploymentBundle needs at least one deployment")
        # Keys are canonical device slugs; normalize so lookup and tuning-time
        # naming can't drift apart ("TPU v4" and "tpu_v4" are the same entry).
        self.deployments = {
            canonical_device_name(name): dep for name, dep in self.deployments.items()
        }

    # -- access --------------------------------------------------------------
    @property
    def devices(self) -> list[str]:
        return sorted(self.deployments)

    def deployment_for(self, device: str, *, strict: bool = False) -> tuple[Deployment, str]:
        """(deployment, resolved device name) serving ``device``.

        Exact match first, then the nearest-device fallback order of
        ``devices.resolve_device``; ``strict=True`` raises
        ``KeyError`` instead of degrading across platform families.
        """
        resolved = resolve_device(device, self.devices, strict=strict)
        if resolved is None:
            raise KeyError(f"no deployment for device {device!r} in bundle {self.devices}")
        return self.deployments[resolved], resolved

    def runtime(self, device: str | None = None, *, strict: bool = False,
                name: str | None = None):
        """A fresh :class:`~repro_torch.core.runtime.KernelRuntime` serving this bundle.

        Each call builds an isolated runtime with this bundle's per-device
        policies installed and the one resolved for ``device`` (default: the
        detected host) activated::

            rt = repro_torch.load_bundle("bundle.json").runtime()
            engine = rt.serve(model, params)
        """
        from .runtime import KernelRuntime

        rt = KernelRuntime(name=name or f"bundle[{'+'.join(self.devices)}]")
        rt.install_bundle(self, device, strict=strict)
        return rt

    def provenance(self) -> dict[str, dict]:
        """Per-device tuning provenance (the v4+ top-level block).

        Extracted from each deployment's meta; devices tuned before
        provenance existed simply have no entry.
        """
        out: dict[str, dict] = {}
        for name, dep in sorted(self.deployments.items()):
            ent = {k: dep.meta[k] for k in _PROVENANCE_KEYS if k in dep.meta}
            if ent:
                out[name] = ent
        return out

    # -- persistence ---------------------------------------------------------
    def to_blob(self) -> dict:
        deployments = {name: dep.to_blob() for name, dep in sorted(self.deployments.items())}
        provenance = self.provenance()
        return {
            "version": BUNDLE_VERSION,
            "format": "bundle",
            "deployments": deployments,
            "provenance": provenance,
            "checksums": _blob_checksums(deployments, provenance),
            "meta": self.meta,
        }

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_blob(), indent=1))

    @staticmethod
    def from_blob(blob: dict) -> "DeploymentBundle":
        """Parse a v3-v6 bundle blob — or wrap a v1/v2/v5 single-device blob.

        v6 blobs get the per-section checksum pass (corrupt family sections
        and device cores are dropped, not fatal — see ``load_errors``);
        structurally unreadable input raises :class:`BundleFormatError` with
        the failing section, never a bare ``KeyError``/``TypeError``.
        """
        if not isinstance(blob, dict):
            raise BundleFormatError(
                f"bundle blob must be a JSON object, got {type(blob).__name__}"
            )
        if blob.get("format") == "bundle" or "deployments" in blob:
            try:
                version = int(blob.get("version", BUNDLE_VERSION))
            except (TypeError, ValueError):
                raise BundleFormatError(
                    f"bundle version is not an integer: {blob.get('version')!r}",
                    section="version") from None
            if version > BUNDLE_VERSION:
                raise BundleFormatError(
                    f"bundle version {version} is newer than supported v{BUNDLE_VERSION}",
                    section="version")
            dep_blobs = blob.get("deployments")
            if not isinstance(dep_blobs, dict) or not dep_blobs:
                raise BundleFormatError(
                    "bundle has no readable 'deployments' section",
                    section="deployments")
            sums = blob.get("checksums") or {}
            load_errors: list[dict] = []
            deps: dict[str, Deployment] = {}
            for name, sub in dep_blobs.items():
                sub = _verify_device_blob(name, sub, sums, load_errors)
                if sub is None:
                    continue
                deps[name] = _parse_deployment(sub, f"deployments.{name}")
            if not deps:
                raise BundleIntegrityError(
                    "no deployment in the bundle survived checksum verification: "
                    + "; ".join(e["section"] for e in load_errors)
                )
            provenance = blob.get("provenance") or {}
            if provenance and "provenance" in sums and (
                _section_checksum(provenance) != sums["provenance"]
            ):
                load_errors.append({
                    "section": "provenance", "error": "checksum mismatch",
                    "action": "provenance dropped",
                })
                provenance = {}
            # v4: reattach the top-level provenance block to each deployment
            # (authoritative for tooling that rewrote it without touching the
            # embedded per-device blobs; older per-device meta wins nothing).
            by_canonical = {canonical_device_name(n): d for n, d in deps.items()}
            for name, ent in provenance.items():
                dep = by_canonical.get(canonical_device_name(name))
                if dep is not None and isinstance(ent, dict):
                    dep.meta.update(ent)
            bundle = DeploymentBundle(deployments=deps, meta=blob.get("meta", {}))
            bundle.load_errors = load_errors
            return bundle
        # v1/v2 single-device file: a degenerate one-entry bundle.
        dep = _parse_deployment(blob, "deployment")
        return DeploymentBundle(deployments={dep.device: dep}, meta=dict(dep.meta))

    @staticmethod
    def load(path: str | Path) -> "DeploymentBundle":
        """Load a bundle (any blob version, v1-v6) from a file path.

        The text rides the ``bundle.load`` chaos site of the current
        runtime's fault plan (simulated bit rot) before it is parsed, so a
        corrupted file surfaces as a structured ``BundleError``.
        """
        text = Path(path).read_text()
        from .runtime import current_runtime

        plan = current_runtime().fault_plan
        if plan is not None:
            text = plan.corrupt_text("bundle.load", text, key=str(path))
        try:
            blob = json.loads(text)
        except json.JSONDecodeError as e:
            raise BundleFormatError(
                f"bundle file {path} is not valid JSON: {e.msg}", offset=e.pos
            ) from e
        return DeploymentBundle.from_blob(blob)


def install_bundle(
    bundle: "DeploymentBundle | str | Path",
    device: str | None = None,
    *,
    strict: bool = False,
    runtime=None,
) -> Deployment:
    """Install the bundle into a runtime: its policies become the registry.

    ``runtime`` names the target :class:`~repro_torch.core.runtime.KernelRuntime`
    (default: the current — usually the process default — runtime; prefer
    :meth:`DeploymentBundle.runtime` for an isolated handle).  Any previously
    registered per-device policies of that runtime are replaced (installing a
    bundle is authoritative — resolution must agree between the bundle and
    the registry, so stale entries from an earlier install cannot shadow this
    bundle's fallback choice).  ``device=None`` detects the host
    (``REPRO_DEVICE`` override first); an untuned host degrades to the
    nearest tuned sibling rather than the untuned ``FixedPolicy`` baseline.
    On a CUDA target it raises when the resolved deployment holds a config
    the port has not compiled.
    Returns the activated ``Deployment``; whether a fallback happened is
    readable from the runtime's ``device_resolution()`` (the shared
    ``Deployment`` objects are never mutated).
    """
    from .runtime import current_runtime

    rt = runtime if runtime is not None else current_runtime()
    return rt.install_bundle(bundle, device, strict=strict)
