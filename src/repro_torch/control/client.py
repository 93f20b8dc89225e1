"""Control-plane client: job submission, telemetry posting, policy long-poll.

Ported from ``repro/control/client.py``: the stdlib-only (``urllib.request``)
counterpart of :class:`~repro_torch.control.service.ControlPlane`, with the
reference's wire format, so either package's client talks to either
package's plane.  Two pieces:

* :class:`ControlPlaneClient` — the request/response surface: submit and
  poll jobs, fetch artifacts (:meth:`~ControlPlaneClient.fetch_bundle`
  returns the port's ``DeploymentBundle``), post a runtime's
  ``TelemetrySnapshot``, and long-poll the per-device policy board.
* :class:`PolicySubscriber` — a background thread that long-polls
  ``GET /policy/<device>`` and delivers each newly announced artifact to a
  subscribed consumer: a :class:`~repro_torch.serve.engine.ServingEngine`
  (via ``offer_deployment`` — adopted canary-gated on the next step
  boundary, its programs captured again) or a bare
  :class:`~repro_torch.core.runtime.KernelRuntime` (via
  ``apply_policy_update``).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request


class ControlPlaneError(RuntimeError):
    """A control-plane request failed (HTTP error or unreachable service)."""


class ControlPlaneClient:
    """HTTP client for one control-plane service (``base_url`` = plane.url)."""

    def __init__(self, base_url: str, *, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- transport ---------------------------------------------------------------
    def _request(self, method: str, path: str, body: dict | None = None,
                 *, timeout: float | None = None):
        url = f"{self.base_url}{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout or self.timeout) as resp:
                if resp.status == 204:
                    return None
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read().decode("utf-8")).get("error", "")
            except (ValueError, AttributeError, OSError):  # the error body is best-effort
                detail = ""
            raise ControlPlaneError(
                f"{method} {url} -> HTTP {e.code}" + (f": {detail}" if detail else "")
            ) from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ControlPlaneError(f"{method} {url} failed: {e}") from e

    # -- surface -----------------------------------------------------------------
    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def submit(self, spec: dict) -> dict:
        """``POST /jobs``: returns the created job record (state ``queued``)."""
        return self._request("POST", "/jobs", spec)

    def job(self, job_id: str) -> dict:
        return self._request("GET", f"/jobs/{job_id}")

    def jobs(self) -> list[dict]:
        return self._request("GET", "/jobs")

    def wait_job(self, job_id: str, *, timeout: float = 600.0,
                 poll_interval: float = 0.2) -> dict:
        """Poll one job to a terminal state; raises on timeout."""
        deadline = time.monotonic() + timeout
        while True:
            job = self.job(job_id)
            if job["state"] in ("succeeded", "failed"):
                return job
            if time.monotonic() > deadline:
                raise ControlPlaneError(
                    f"job {job_id} still {job['state']!r} after {timeout:.0f}s"
                )
            time.sleep(poll_interval)

    def artifacts(self) -> dict:
        return self._request("GET", "/artifacts")

    def artifact(self, name: str, version: str = "latest") -> dict:
        """The registry envelope (record + bundle blob) for one version."""
        return self._request("GET", f"/artifacts/{name}/{version}")

    def registry_uri(self, name: str, version: str = "latest") -> str:
        """The ``registry://`` URI ``repro_torch.load_bundle`` opens for this artifact."""
        host = self.base_url.split("://", 1)[-1]
        return f"registry://{host}/{name}/{version}"

    def fetch_bundle(self, name: str, version: str = "latest"):
        """Fetch and parse one artifact as the port's ``DeploymentBundle``."""
        from ..core.bundle import DeploymentBundle

        return DeploymentBundle.from_blob(self.artifact(name, version)["blob"])

    def post_telemetry(self, device: str, snapshot, *, host: str | None = None,
                       artifact: str = "default") -> dict:
        """``POST /telemetry`` one snapshot (object or wire dict); returns the ack."""
        wire = snapshot.to_json() if hasattr(snapshot, "to_json") else dict(snapshot)
        return self._request("POST", "/telemetry", {
            "device": device,
            "snapshot": wire,
            "artifact": artifact,
            **({"host": host} if host else {}),
        })

    def policy(self, device: str, *, after: int = 0,
               timeout: float = 25.0) -> dict | None:
        """One policy long-poll; ``None`` when nothing newer than ``after``."""
        return self._request(
            "GET", f"/policy/{device}?after={int(after)}&timeout={float(timeout)}",
            timeout=timeout + 10.0,
        )


class PolicySubscriber:
    """Background long-poller delivering policy-board updates to one consumer.

    ``target`` is a ``ServingEngine`` (delivery = ``offer_deployment``, so
    the artifact adopts canary-gated on the engine's next step boundary) or
    a ``KernelRuntime`` (delivery = ``apply_policy_update``, the immediate
    lock+epoch hot-swap).  ``start_from="current"`` (default) skips whatever
    the board already announced — only *new* versions after subscription are
    delivered; ``start_from=0`` replays the newest existing entry first.
    ``updates`` records every delivered board entry, newest last; ``errors``
    every failed poll or delivery, among them a deployment the target
    refuses (``apply_policy_update`` on a CUDA target raises ``ValueError``
    for configs the port has not compiled).
    """

    def __init__(
        self,
        client: ControlPlaneClient,
        device: str,
        target,
        *,
        artifact: str = "default",
        start_from: int | str = "current",
        poll_timeout: float = 10.0,
    ):
        self.client = client
        self.device = device
        self.target = target
        self.artifact = artifact
        self.poll_timeout = poll_timeout
        self.updates: list[dict] = []
        self.errors: list[str] = []
        self._start_from = start_from
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "PolicySubscriber":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name=f"policy-subscriber[{self.device}]", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_timeout + 15.0)
            self._thread = None

    def __enter__(self) -> "PolicySubscriber":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _initial_seq(self) -> int:
        if self._start_from != "current":
            return int(self._start_from)
        try:
            ent = self.client.policy(self.device, after=0, timeout=0.0)
        except ControlPlaneError:
            return 0
        return int(ent["seq"]) if ent else 0

    def _deliver(self, ent: dict) -> None:
        bundle = self.client.fetch_bundle(ent["name"], ent["version"])
        dep, _resolved = bundle.deployment_for(self.device)
        if hasattr(self.target, "offer_deployment"):
            self.target.offer_deployment(dep, source="control-plane")
        elif hasattr(self.target, "apply_policy_update"):
            self.target.apply_policy_update(dep, self.device)
        else:
            raise TypeError(
                f"subscriber target {type(self.target).__name__} accepts neither "
                "offer_deployment (engine) nor apply_policy_update (runtime)"
            )
        self.updates.append(dict(ent))

    def _run(self) -> None:
        seq = self._initial_seq()
        while not self._stop.is_set():
            try:
                ent = self.client.policy(
                    self.device, after=seq, timeout=self.poll_timeout
                )
            except ControlPlaneError as e:
                if self._stop.is_set():
                    return
                self.errors.append(str(e))
                self._stop.wait(0.5)  # transient: back off and re-poll
                continue
            if ent is None:
                continue  # long-poll timed out: nothing newer yet
            if self.artifact and ent.get("name") != self.artifact:
                seq = int(ent["seq"])
                continue  # another artifact's announcement; not ours
            try:
                self._deliver(ent)
            except (ControlPlaneError, KeyError, TypeError, ValueError) as e:
                self.errors.append(str(e))
            seq = int(ent["seq"])
