"""Versioned, content-addressed artifact registry for tuned bundles.

Ported from ``repro/control/registry.py`` (framework-free: the port's own
copy).  Every bundle the control plane produces is published here: the
**version is the content hash** (sha256 of the bundle's canonical JSON,
truncated to 12 hex chars), so publishing the same bundle twice lands on the
same version instead of minting a duplicate, while any change to the blob
changes the version.  The bundle JSON is the reference's byte for byte, so
one blob has one version in both packages' registries.  The reference's
tunes are deterministic for a fixed spec; the port's are measured on the
card, so a repeated tune job there mints a new version (a new table, a new
blob).  Each version carries its **tuning lineage**: the submitted spec, the
parent version it was retuned from (``None`` for a bring-up tune), and the
bundle's own per-device provenance block.

With ``root`` set, every version is written to ``<root>/<name>/<version>.json``
(the reference's layout and record, key for key, so either package reloads
a root the other wrote) and reloaded on construction.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from pathlib import Path


def content_version(blob: dict) -> str:
    """The content-hash version of a bundle blob (12 hex chars of sha256)."""
    payload = json.dumps(blob, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(payload).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class ArtifactVersion:
    """One published bundle version and its tuning lineage."""

    name: str
    version: str  # content hash — same blob, same version
    seq: int  # publish order within the name (latest = highest)
    created: float  # wall time of first publish
    lineage: dict  # {"spec": ..., "parent": ..., "provenance": {...}}

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "version": self.version,
            "seq": self.seq,
            "created": self.created,
            "lineage": self.lineage,
        }

    @staticmethod
    def from_json(rec: dict) -> "ArtifactVersion":
        return ArtifactVersion(
            name=str(rec["name"]),
            version=str(rec["version"]),
            seq=int(rec["seq"]),
            created=float(rec.get("created", 0.0)),
            lineage=dict(rec.get("lineage") or {}),
        )


class ArtifactRegistry:
    """Thread-safe versioned store of deployment bundles.

    ``publish`` is idempotent on content: re-publishing a byte-identical
    blob under the same name returns the existing :class:`ArtifactVersion`.
    ``get(name)`` / ``get(name, "latest")`` resolve to the most recently
    *published* version — lineage order, not hash order.
    """

    def __init__(self, root: str | Path | None = None):
        self._lock = threading.RLock()
        # name -> version -> (ArtifactVersion, blob); publish order per name.
        self._store: dict[str, dict[str, tuple[ArtifactVersion, dict]]] = {}
        self._order: dict[str, list[str]] = {}
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self._reload()

    # -- publish ---------------------------------------------------------------
    def publish(
        self,
        name: str,
        bundle,
        *,
        spec: dict | None = None,
        parent: str | None = None,
    ) -> ArtifactVersion:
        """Version and store one bundle (a ``DeploymentBundle`` or its blob).

        Returns the (possibly pre-existing) :class:`ArtifactVersion`.
        """
        blob = bundle.to_blob() if hasattr(bundle, "to_blob") else dict(bundle)
        version = content_version(blob)
        with self._lock:
            versions = self._store.setdefault(name, {})
            if version in versions:
                return versions[version][0]  # idempotent: same content, same version
            lineage = {
                "spec": dict(spec) if spec else {},
                "parent": parent,
                "provenance": blob.get("provenance") or {},
            }
            rec = ArtifactVersion(
                name=name,
                version=version,
                seq=len(self._order.setdefault(name, [])),
                created=time.time(),
                lineage=lineage,
            )
            versions[version] = (rec, blob)
            self._order[name].append(version)
            if self.root is not None:
                self._persist(rec, blob)
            return rec

    # -- lookup ----------------------------------------------------------------
    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._store)

    def versions(self, name: str) -> list[ArtifactVersion]:
        """Publish-ordered versions of one artifact (oldest first)."""
        with self._lock:
            if name not in self._store:
                raise KeyError(f"no artifact named {name!r} (have: {self.names()})")
            return [self._store[name][v][0] for v in self._order[name]]

    def latest(self, name: str) -> ArtifactVersion:
        return self.versions(name)[-1]

    def get(self, name: str, version: str = "latest") -> tuple[ArtifactVersion, dict]:
        """``(record, bundle blob)`` for one version (``"latest"`` resolves)."""
        with self._lock:
            if name not in self._store:
                raise KeyError(f"no artifact named {name!r} (have: {self.names()})")
            if version == "latest":
                version = self._order[name][-1]
            if version not in self._store[name]:
                have = self._order[name]
                raise KeyError(
                    f"artifact {name!r} has no version {version!r} (have: {have})"
                )
            return self._store[name][version]

    def get_bundle(self, name: str, version: str = "latest"):
        """The parsed :class:`~repro_torch.core.bundle.DeploymentBundle` for one version."""
        from ..core.bundle import DeploymentBundle

        _rec, blob = self.get(name, version)
        return DeploymentBundle.from_blob(blob)

    # -- persistence -------------------------------------------------------------
    def _persist(self, rec: ArtifactVersion, blob: dict) -> None:
        d = self.root / rec.name
        d.mkdir(parents=True, exist_ok=True)
        payload = {"format": "artifact", **rec.to_json(), "blob": blob}
        (d / f"{rec.version}.json").write_text(json.dumps(payload))

    def _reload(self) -> None:
        if not self.root.exists():
            return
        recs: list[tuple[ArtifactVersion, dict]] = []
        for path in self.root.glob("*/*.json"):
            try:
                payload = json.loads(path.read_text())
                recs.append((ArtifactVersion.from_json(payload), payload["blob"]))
            except (ValueError, KeyError):
                continue  # a torn write never blocks the rest of the store
        for rec, blob in sorted(recs, key=lambda rb: (rb[0].name, rb[0].seq)):
            self._store.setdefault(rec.name, {})[rec.version] = (rec, blob)
            self._order.setdefault(rec.name, []).append(rec.version)
