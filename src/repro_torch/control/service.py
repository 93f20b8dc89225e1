"""The tuning control plane: job service + registry + telemetry federation.

Ported from ``repro/control/service.py``.  Stdlib-only
(``http.server.ThreadingHTTPServer``): the service that makes the
tune→deploy→retune loop operable as a *fleet* instead of a process
(DESIGN.md §14).  Every route, status code and JSON body is the
reference's, so either package's client talks to either package's plane.

**Job API.**  ``POST /jobs`` accepts a tune spec (``device``/``devices``,
``families``, ``archs``, ``prune_ratio``, ``measure_budget`` — including
``"auto"`` —, ``n_kernels``, ``max_problems``, ``seed``) and runs
:func:`repro_torch.core.tuner.tune_fleet` on a background worker: the card's
tables are measured there (``core/gpubench.py``).  Jobs move ``queued →
running → succeeded/failed`` with a timestamped history; ``GET /jobs/<id>``
polls, ``GET /healthz`` liveness-checks.  Where the port departs from the
reference: a spec naming no device tunes :func:`~repro_torch.core.tuner.
default_fleet` (this card and ``host_cpu``, or ``host_cpu`` alone) where the
reference tunes ``tpu_v5e``; a device this host cannot measure (a TPU,
another card) fails the job with ``tune_fleet``'s message; and
``transfer: true`` fails it with :data:`~repro_torch.core.tuner.
TRANSFER_REFUSED`, the tune CLI's message.

**Artifact registry.**  Every produced bundle is published to an
:class:`~repro_torch.control.registry.ArtifactRegistry`, content-hashed and
stored with its tuning lineage, fetchable via ``GET
/artifacts/<name>/<version>`` (and ``latest``).
``repro_torch.load_bundle("registry://host:port/name")`` opens it directly.

**Telemetry federation.**  Serving hosts ``POST /telemetry`` serialized
``TelemetrySnapshot``\\ s; the service merges them per device (the
commutative ``merge``), runs ``detect_drift_all`` against the artifact's
provenance, and schedules an incremental-retune job when a family triggers.
The retune's matmul table comes from ``retune_dataset_builder`` (default:
the H100 model, as the engine's), e.g. ``gpubench.build_gpu_dataset`` to
measure it on the card.  The retuned bundle is published as a child version
and announced on the per-device **policy board**; subscribed runtimes
long-poll ``GET /policy/<device>`` and feed the new artifact into the
canary-gated hot swap (``ServingEngine.offer_deployment``).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..core.retune import (
    DEFAULT_DRIFT_THRESHOLD,
    DEFAULT_MIN_EVENTS,
    TelemetrySnapshot,
    _model_dataset_builder,
    detect_drift_all,
    incremental_retune,
)
from .registry import ArtifactRegistry

DEFAULT_ARTIFACT = "default"


@dataclasses.dataclass
class Job:
    """One control-plane job and its lifecycle record."""

    id: str
    kind: str  # "tune" | "retune"
    spec: dict
    state: str = "queued"
    error: str | None = None
    artifact: dict | None = None  # {"name": ..., "version": ...} on success
    history: list = dataclasses.field(default_factory=list)  # [(state, t)]

    def transition(self, state: str) -> None:
        self.state = state
        self.history.append((state, time.time()))

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "kind": self.kind,
            "spec": self.spec,
            "state": self.state,
            "error": self.error,
            "artifact": self.artifact,
            "history": [[s, t] for s, t in self.history],
        }


class ControlPlane:
    """In-process tuning control plane (service object + HTTP front end).

    ``port=0`` binds an ephemeral port (read ``plane.port`` after
    :meth:`start`); ``registry_root`` persists published artifacts to disk.
    ``tuner`` overrides the bring-up runner (``callable(spec) -> bundle``) —
    the test seam for fast or deliberately crashing tunes; the default runs
    :func:`repro_torch.core.tuner.tune_fleet`.  ``retune_dataset_builder``
    (``(problems, device) -> TuningDataset``) supplies a retune job's matmul
    table, as the engine's keyword of the same name does.  Usable as a
    context manager::

        with ControlPlane(port=0) as plane:
            client = ControlPlaneClient(plane.url)
            job = client.submit({"archs": ["granite-8b"]})
    """

    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: ArtifactRegistry | None = None,
        registry_root=None,
        drift_threshold: float = DEFAULT_DRIFT_THRESHOLD,
        min_events: int = DEFAULT_MIN_EVENTS,
        tuner=None,
        retune_dataset_builder=_model_dataset_builder,
    ):
        self.host = host
        self.port = port
        self.registry = registry if registry is not None else ArtifactRegistry(registry_root)
        self.drift_threshold = drift_threshold
        self.min_events = min_events
        self.retune_dataset_builder = retune_dataset_builder
        self._tuner = tuner
        self._lock = threading.RLock()
        self._jobs: dict[str, Job] = {}
        self._job_ids = itertools.count(1)
        self._queue: queue.Queue = queue.Queue()
        # Telemetry federation: one merged snapshot per device.
        self._federation: dict[str, TelemetrySnapshot] = {}
        self._federation_hosts: dict[str, set] = {}
        # Policy board: device -> {"seq", "name", "version", "job"};
        # long-pollers wait on the condition for a seq advance.
        self._policy_cond = threading.Condition(self._lock)
        self._policy: dict[str, dict] = {}
        self._server: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._started = time.time()

    # -- lifecycle -------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ControlPlane":
        if self._server is not None:
            return self
        handler = _make_handler(self)
        self._server = ThreadingHTTPServer((self.host, self.port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._started = time.time()
        serve = threading.Thread(
            target=self._server.serve_forever, name="control-plane-http", daemon=True
        )
        work = threading.Thread(
            target=self._worker, name="control-plane-worker", daemon=True
        )
        self._threads = [serve, work]
        serve.start()
        work.start()
        return self

    def stop(self) -> None:
        if self._server is None:
            return
        self._queue.put(None)  # worker sentinel
        self._server.shutdown()
        self._server.server_close()
        for t in self._threads:
            t.join(timeout=10.0)
        self._server = None
        self._threads = []
        with self._policy_cond:
            self._policy_cond.notify_all()  # release any parked long-pollers

    def __enter__(self) -> "ControlPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- job API ---------------------------------------------------------------
    def submit_job(self, spec: dict) -> Job:
        """Validate, enqueue, and return one job (the ``POST /jobs`` body)."""
        if not isinstance(spec, dict):
            raise ValueError("job spec must be a JSON object")
        kind = str(spec.get("kind", "tune"))
        if kind not in ("tune", "retune"):
            raise ValueError(f"unknown job kind {kind!r} (tune | retune)")
        if kind == "retune" and not spec.get("device"):
            raise ValueError("a retune job spec needs a 'device'")
        with self._lock:
            job = Job(id=f"job-{next(self._job_ids):04d}", kind=kind, spec=dict(spec))
            job.transition("queued")
            self._jobs[job.id] = job
        self._queue.put(job.id)
        return job

    def job(self, job_id: str) -> Job:
        with self._lock:
            if job_id not in self._jobs:
                raise KeyError(f"no job {job_id!r}")
            return self._jobs[job_id]

    def jobs(self) -> list[Job]:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.id)

    def _worker(self) -> None:
        """Background runner: jobs execute one at a time, in submit order."""
        while True:
            job_id = self._queue.get()
            if job_id is None:
                return
            job = self.job(job_id)
            job.transition("running")
            try:
                artifact = (
                    self._run_tune(job) if job.kind == "tune" else self._run_retune(job)
                )
            except Exception as e:  # noqa: BLE001 — a crashed tune is a *failed job*
                job.error = f"{type(e).__name__}: {e}"
                job.transition("failed")
                continue
            job.artifact = artifact
            job.transition("succeeded")

    # -- bring-up tunes ----------------------------------------------------------
    def _run_tune(self, job: Job) -> dict:
        spec = job.spec
        name = str(spec.get("name", DEFAULT_ARTIFACT))
        if self._tuner is not None:
            bundle = self._tuner(spec)
        else:
            from ..core.tuner import TRANSFER_REFUSED, tune_fleet

            if spec.get("transfer"):
                raise ValueError(TRANSFER_REFUSED)
            devices = spec.get("devices") or ([spec["device"]] if spec.get("device") else None)
            kwargs = dict(
                device_names=tuple(devices) if devices else None,
                prune_ratio=spec.get("prune_ratio"),
                measure_budget=spec.get("measure_budget"),
            )
            for key in ("n_kernels", "max_problems", "seed"):
                if spec.get(key) is not None:
                    kwargs[key] = int(spec[key])
            if spec.get("families") is not None:
                kwargs["families"] = list(spec["families"])
            bundle = tune_fleet(spec.get("archs"), **kwargs).bundle
        rec = self.registry.publish(name, bundle, spec=spec)
        self._announce(list(bundle.devices), name, rec.version, job.id)
        return {"name": name, "version": rec.version, "devices": list(bundle.devices)}

    # -- federation + retune -----------------------------------------------------
    def handle_telemetry(
        self,
        device: str,
        snapshot: dict | TelemetrySnapshot,
        *,
        artifact: str = DEFAULT_ARTIFACT,
        host: str | None = None,
    ) -> dict:
        """Merge one host's snapshot; drift-check; maybe schedule a retune.

        The ``POST /telemetry`` core: the snapshot folds into the device's
        federated aggregate (commutative merge — host arrival order is
        irrelevant), the aggregate is checked against the artifact's
        provenance, and the first triggering report enqueues an
        incremental-retune job (deduplicated: one in-flight retune per
        device/artifact pair).
        """
        snap = (
            snapshot
            if isinstance(snapshot, TelemetrySnapshot)
            else TelemetrySnapshot.from_json(snapshot)
        )
        with self._lock:
            merged = self._federation.setdefault(device, TelemetrySnapshot())
            merged.merge(snap)
            if host:
                self._federation_hosts.setdefault(device, set()).add(str(host))
            n_hosts = len(self._federation_hosts.get(device) or ())
            events = merged.n_events
        drift: dict[str, dict] = {}
        retune_job = None
        try:
            bundle = self.registry.get_bundle(artifact)
            dep, _resolved = bundle.deployment_for(device)
        except KeyError:
            dep = None  # nothing deployed yet: merge-only, no verdict
        if dep is not None:
            with self._lock:
                reports = detect_drift_all(
                    self._federation[device], dep,
                    threshold=self.drift_threshold, min_events=self.min_events,
                )
            drift = {
                f: {
                    "score": round(r.score, 6),
                    "n_events": r.n_events,
                    "triggered": r.triggered,
                }
                for f, r in reports.items()
            }
            triggered = sorted(f for f, r in reports.items() if r.triggered)
            with self._lock:  # check-then-submit: one retune per device/artifact pair
                if triggered and not self._retune_pending(device, artifact):
                    retune_job = self.submit_job({
                        "kind": "retune",
                        "device": device,
                        "artifact": artifact,
                        "families": triggered,
                    }).id
        return {
            "device": device,
            "merged_events": events,
            "hosts": n_hosts,
            "drift": drift,
            "retune_job": retune_job,
        }

    def _retune_pending(self, device: str, artifact: str) -> bool:
        with self._lock:
            return any(
                j.kind == "retune"
                and j.state in ("queued", "running")
                and j.spec.get("device") == device
                and j.spec.get("artifact", DEFAULT_ARTIFACT) == artifact
                for j in self._jobs.values()
            )

    def _run_retune(self, job: Job) -> dict:
        from ..core.bundle import DeploymentBundle

        spec = job.spec
        device = spec["device"]
        name = str(spec.get("artifact", DEFAULT_ARTIFACT))
        rec, blob = self.registry.get(name)
        bundle = DeploymentBundle.from_blob(blob)
        dep, resolved = bundle.deployment_for(device)
        with self._lock:
            snap = self._federation.get(device)
            snap = TelemetrySnapshot.from_json(snap.to_json()) if snap else None
        if snap is None or snap.n_events == 0:
            raise ValueError(f"no federated telemetry for device {device!r}")
        reports = detect_drift_all(
            snap, dep, threshold=self.drift_threshold, min_events=self.min_events
        )
        families = [f for f in (spec.get("families") or sorted(reports)) if f in reports]
        new_dep, retuned = dep, []
        for fam in families:
            new_dep = incremental_retune(
                new_dep, snap, family=fam, report=reports[fam],
                threshold=self.drift_threshold, min_events=self.min_events,
                dataset_builder=self.retune_dataset_builder,
            ).deployment
            retuned.append(fam)
        if not retuned:
            raise ValueError(
                f"retune job had no family to refresh (asked: {spec.get('families')})"
            )
        new_bundle = DeploymentBundle(
            deployments={**bundle.deployments, resolved: new_dep},
            meta=dict(bundle.meta),
        )
        new_rec = self.registry.publish(name, new_bundle, spec=spec, parent=rec.version)
        with self._lock:
            # Fresh federation window: the next drift verdict is judged
            # against the *retuned* artifact's provenance, not stale traffic.
            self._federation.pop(device, None)
            self._federation_hosts.pop(device, None)
        self._announce([resolved], name, new_rec.version, job.id)
        return {
            "name": name,
            "version": new_rec.version,
            "parent": rec.version,
            "device": resolved,
            "families": retuned,
        }

    # -- policy board ------------------------------------------------------------
    def _announce(self, devices: list[str], name: str, version: str, job_id: str) -> None:
        with self._policy_cond:
            for dev in devices:
                prev = self._policy.get(dev) or {"seq": 0}
                self._policy[dev] = {
                    "device": dev,
                    "seq": int(prev["seq"]) + 1,
                    "name": name,
                    "version": version,
                    "job": job_id,
                }
            self._policy_cond.notify_all()

    def policy_state(self, device: str) -> dict | None:
        with self._lock:
            ent = self._policy.get(device)
            return dict(ent) if ent else None

    def wait_policy(self, device: str, after: int = 0, timeout: float = 25.0) -> dict | None:
        """Block until the device's policy board advances past ``after``.

        The long-poll core of ``GET /policy/<device>``: returns the newest
        entry once its seq exceeds ``after``, or ``None`` on timeout or once
        :meth:`stop` ran (the HTTP layer answers 204 and the subscriber
        re-polls).
        """
        deadline = time.monotonic() + max(float(timeout), 0.0)
        with self._policy_cond:
            while True:
                ent = self._policy.get(device)
                if ent and int(ent["seq"]) > int(after):
                    return dict(ent)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._server is None:
                    return None
                self._policy_cond.wait(remaining)

    # -- health -------------------------------------------------------------------
    def health(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for j in self._jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            return {
                "status": "ok",
                "uptime_s": round(time.time() - self._started, 3),
                "jobs": states,
                "artifacts": {
                    n: len(self.registry.versions(n)) for n in self.registry.names()
                },
                "devices": sorted(self._policy),
            }


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------
def _make_handler(plane: ControlPlane):
    class Handler(BaseHTTPRequestHandler):
        # One small JSON API; request logging is the caller's business.
        def log_message(self, *args):  # noqa: D102
            pass

        def _send(self, code: int, payload=None) -> None:
            body = b"" if payload is None else json.dumps(payload).encode()
            self.send_response(code)
            if body:
                self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            blob = json.loads(raw.decode("utf-8"))
            if not isinstance(blob, dict):
                raise ValueError("request body must be a JSON object")
            return blob

        def _route(self) -> tuple[list[str], dict]:
            path, _, q = self.path.partition("?")
            parts = [p for p in path.split("/") if p]
            params = {}
            for pair in q.split("&"):
                if "=" in pair:
                    k, _, v = pair.partition("=")
                    params[k] = v
            return parts, params

        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            parts, params = self._route()
            try:
                if parts == ["healthz"]:
                    return self._send(200, plane.health())
                if parts == ["jobs"]:
                    return self._send(200, [j.to_json() for j in plane.jobs()])
                if len(parts) == 2 and parts[0] == "jobs":
                    return self._send(200, plane.job(parts[1]).to_json())
                if parts == ["artifacts"]:
                    return self._send(200, {
                        n: [r.to_json() for r in plane.registry.versions(n)]
                        for n in plane.registry.names()
                    })
                if len(parts) == 2 and parts[0] == "artifacts":
                    return self._send(
                        200, [r.to_json() for r in plane.registry.versions(parts[1])]
                    )
                if len(parts) == 3 and parts[0] == "artifacts":
                    rec, blob = plane.registry.get(parts[1], parts[2])
                    return self._send(
                        200, {"format": "artifact", **rec.to_json(), "blob": blob}
                    )
                if len(parts) == 2 and parts[0] == "policy":
                    ent = plane.wait_policy(
                        parts[1],
                        after=int(params.get("after", 0)),
                        timeout=min(float(params.get("timeout", 25.0)), 60.0),
                    )
                    if ent is None:
                        return self._send(204)  # nothing newer: re-poll
                    return self._send(200, ent)
                return self._send(404, {"error": f"no route for GET {self.path}"})
            except KeyError as e:
                return self._send(404, {"error": str(e)})
            except ValueError as e:
                return self._send(400, {"error": str(e)})

        def do_POST(self) -> None:  # noqa: N802 (http.server API)
            parts, _params = self._route()
            try:
                body = self._body()
                if parts == ["jobs"]:
                    job = plane.submit_job(body)
                    return self._send(202, job.to_json())
                if parts == ["telemetry"]:
                    for key in ("device", "snapshot"):
                        if key not in body:
                            raise ValueError(f"telemetry post needs {key!r}")
                    ack = plane.handle_telemetry(
                        str(body["device"]),
                        body["snapshot"],
                        artifact=str(body.get("artifact", DEFAULT_ARTIFACT)),
                        host=body.get("host"),
                    )
                    return self._send(200, ack)
                return self._send(404, {"error": f"no route for POST {self.path}"})
            except (ValueError, KeyError) as e:
                return self._send(400, {"error": str(e)})

    return Handler
