"""The port's tuning control plane (``repro_torch.control``) against the JAX package's.

Every case of ``tests/test_control.py`` runs on the port: registry content
versions, idempotent publish, disk round trips, ``parse_registry_uri`` and
``load_bundle("registry://...")``, the job walk, failed jobs, routes,
health, federation with one retune trigger, the policy long-poll and
subscribers to a runtime.  The port's bundle there is tuned on the H100
model (``build_model_dataset`` at the card's name), which a retune job's
default ``retune_dataset_builder`` models too.

Held against the reference on one input: content versions of one bundle
tuned in both packages; ``parse_registry_uri`` over a table of URIs,
malformed ones included; registry roots written by one package and reloaded
by the other; the acks of both planes for the same telemetry posts (merged
events, drift scores to 1e-9, trigger decisions, the retuned configs); the
port's client against the reference's plane and the reference's client
against the port's plane; and a ``PolicySubscriber`` on a CPU engine of
each package, fed by one plane, whose streams after the swap are equal.
Every long-poll here uses a short ``poll_timeout``.
"""
import importlib
import json
import threading
import time

import numpy as np
import pytest

import repro_torch
from _torch_parity import reduced_pair
from repro.core.bundle import DeploymentBundle as JaxBundle
from repro.core.dataset import build_model_dataset as jax_model_dataset
from repro.core.dataset import synthetic_problems as jax_synthetic
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.core.tuner import tune as jax_tune
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.control import (
    ArtifactRegistry,
    ArtifactVersion,
    ControlPlane,
    ControlPlaneClient,
    ControlPlaneError,
    PolicySubscriber,
    content_version,
)
from repro_torch.core import dataset, pipeline, retune, tuner
from repro_torch.core.bundle import BundleFormatError, DeploymentBundle, parse_registry_uri
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import attention as at
from repro_torch.kernels import matmul as mm
from repro_torch.serve.engine import ServingEngine

jax_control, jax_bundle_mod, jax_pipeline, jax_dataset, jax_retune = (importlib.import_module(m) for m in (
    "repro.control", "repro.core.bundle", "repro.core.pipeline", "repro.core.dataset", "repro.core.retune"))

CARD = "gpu_nvidia_h100_80gb_hbm3"
POLL = 1.0  # every subscriber's long-poll, seconds


@pytest.fixture(scope="module")
def tuned_bundle():
    """The port's bundle: the H100 model's table tuned for the card's name."""
    ds = dataset.build_model_dataset(dataset.synthetic_problems(80), device_name=CARD)
    res = tuner.tune(ds, n_kernels=6, families=[])
    return DeploymentBundle({CARD: res.deployment}, meta={"test": True})


@pytest.fixture()
def plane(tuned_bundle):
    """A running control plane whose tuner seam returns the tuned bundle."""
    p = ControlPlane(port=0, min_events=10, tuner=lambda spec: tuned_bundle)
    p.start()
    yield p
    p.stop()


@pytest.fixture(scope="module")
def tpu_bundles(tmp_path_factory):
    """Two reference tunes (6 and 4 matmul kernels) of the TPU model's table, each saved
    as a v6 bundle JSON that both packages load."""
    root = tmp_path_factory.mktemp("control")
    ds = jax_model_dataset(jax_synthetic(80), device_name="tpu_v5e")
    paths = []
    for n in (6, 4):
        path = root / f"bundle{n}.json"
        JaxBundle({"tpu_v5e": jax_tune(ds, n_kernels=n).deployment}).save(path)
        paths.append(path)
    return paths


def _port_table(problems, device):
    """The reference's TPU-model table at ``problems`` (what its plane retunes on)."""
    ds = jax_model_dataset(problems, device_name="tpu_v5e")
    return dataset.TuningDataset(device=ds.device, problems=list(ds.problems),
                                 configs=[mm.MatmulConfig(**c.to_dict()) for c in ds.configs], perf=np.asarray(ds.perf))


def _shifted_snapshot(n: int = 100, seed: int = 1, snap_cls=retune.TelemetrySnapshot):
    """Deep-k decode traffic, disjoint from the synthetic tuning mix."""
    rng = np.random.default_rng(seed)
    snap = snap_cls()
    for _ in range(n):
        p = (int(rng.choice([1, 2, 4])), int(rng.choice([8192, 16384])),
             int(rng.choice([1024, 2048])), 1)
        b = retune.shape_bucket(p)
        snap.matmul_counts[b] = snap.matmul_counts.get(b, 0) + 1
        snap.problems[b] = p
        snap.n_events += 1
    return snap


def _tune(client: ControlPlaneClient, name: str = "default") -> dict:
    job = client.submit({"kind": "tune", "name": name})
    return client.wait_job(job["id"], timeout=60)


# ---------------------------------------------------------------------------
# content-hash versioning + the registry
# ---------------------------------------------------------------------------
def test_content_version_tracks_content():
    blob = {"a": 1, "nested": {"x": [1, 2]}}
    v1 = content_version(blob)
    assert v1 == content_version({"nested": {"x": [1, 2]}, "a": 1})  # key order
    assert v1 != content_version({**blob, "a": 2})
    assert len(v1) == 12 and int(v1, 16) >= 0
    assert v1 == jax_control.content_version(blob)


def test_publish_is_idempotent_on_content(tuned_bundle):
    reg = ArtifactRegistry()
    r1 = reg.publish("default", tuned_bundle, spec={"archs": ["a"]})
    r2 = reg.publish("default", tuned_bundle, spec={"archs": ["a"]})
    assert r1.version == r2.version and r1.seq == r2.seq == 0
    assert [r.version for r in reg.versions("default")] == [r1.version]


def test_changed_blob_mints_new_version(tuned_bundle):
    reg = ArtifactRegistry()
    r1 = reg.publish("default", tuned_bundle)
    changed = DeploymentBundle(dict(tuned_bundle.deployments), meta={**tuned_bundle.meta, "note": "v2"})
    r2 = reg.publish("default", changed, parent=r1.version)
    assert r2.version != r1.version
    assert (r1.seq, r2.seq) == (0, 1)
    assert reg.latest("default").version == r2.version
    assert r2.lineage["parent"] == r1.version
    rec, blob = reg.get("default", r1.version)  # older versions stay fetchable
    assert rec.version == r1.version == content_version(blob)


def test_registry_round_trips_through_disk(tmp_path, tuned_bundle):
    reg = ArtifactRegistry(tmp_path)
    rec = reg.publish("fleet", tuned_bundle, spec={"devices": [CARD]})
    reborn = ArtifactRegistry(tmp_path)  # a restarted control plane
    rec2, blob2 = reborn.get("fleet")
    assert rec2 == ArtifactVersion.from_json(rec.to_json())
    assert blob2 == tuned_bundle.to_blob()
    got = reborn.get_bundle("fleet")
    assert isinstance(got, DeploymentBundle) and got.provenance() == tuned_bundle.provenance()


def test_unknown_artifact_and_version_raise(tuned_bundle):
    reg = ArtifactRegistry()
    with pytest.raises(KeyError):
        reg.get("nope")
    reg.publish("default", tuned_bundle)
    with pytest.raises(KeyError):
        reg.get("default", "cafecafecafe")


def test_content_version_equal_for_one_bundle_tuned_in_both_packages():
    """Each package tunes the same table (the reference's TPU model, 10 configs); the
    blobs are equal JSON, so both registries mint one version."""
    full = jax_model_dataset(jax_synthetic(80, seed=5))
    cols = np.linspace(0, len(full.configs) - 1, 10).astype(int)
    ref_cfgs = [full.configs[i] for i in cols]
    perf = np.asarray(full.perf)[:, cols].copy()
    ref_attn = list(importlib.import_module("repro.kernels.attention").attention_config_space()[:2])
    out = []
    for pkg_pipeline, pkg_dataset, cfgs, attn, bundle_cls in (
            (pipeline, dataset, [mm.MatmulConfig(**c.to_dict()) for c in ref_cfgs],
             [at.AttentionConfig(**c.to_dict()) for c in ref_attn], DeploymentBundle),
            (jax_pipeline, jax_dataset, ref_cfgs, ref_attn, JaxBundle)):
        ds = pkg_dataset.TuningDataset(device="tpu_v5e", problems=list(full.problems), configs=cfgs, perf=perf)
        dep = pkg_pipeline.tune_dataset(ds, n_kernels=4, seed=0, families=[]).deployment
        dep.set_family_tuning("attention", attn, None)  # each package's default differs: equal values in both
        out.append(bundle_cls({"tpu_v5e": dep}, meta={"archs": "synthetic"}))
    port, ref = out
    assert content_version(port.to_blob()) == jax_control.content_version(ref.to_blob())
    rec = ArtifactRegistry().publish("default", port)
    assert rec.version == jax_control.ArtifactRegistry().publish("default", ref).version


def test_registries_reload_each_others_roots(tmp_path, tpu_bundles):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    jreg, treg = jax_control.ArtifactRegistry(ref_root), ArtifactRegistry(port_root)
    jrecs = [jreg.publish("fleet", JaxBundle.load(p), spec={"n": i}, parent=None if i == 0 else "x")
             for i, p in enumerate(tpu_bundles)]
    trecs = [treg.publish("fleet", DeploymentBundle.load(p), spec={"n": i}, parent=None if i == 0 else "x")
             for i, p in enumerate(tpu_bundles)]
    assert [r.version for r in jrecs] == [r.version for r in trecs]  # one blob, one version
    # The same layout and record, key for key.
    assert sorted(p.relative_to(ref_root) for p in ref_root.rglob("*.json")) == sorted(
        p.relative_to(port_root) for p in port_root.rglob("*.json"))
    for path in ref_root.rglob("*.json"):
        want = json.loads(path.read_text())
        got = json.loads((port_root / path.relative_to(ref_root)).read_text())
        assert set(got) == set(want) and got["blob"] == want["blob"] and got["lineage"] == want["lineage"]
    by_port, by_ref = ArtifactRegistry(ref_root), jax_control.ArtifactRegistry(port_root)
    assert [r.to_json() for r in by_port.versions("fleet")] == [r.to_json() for r in jreg.versions("fleet")]
    assert [r.to_json() for r in by_ref.versions("fleet")] == [r.to_json() for r in treg.versions("fleet")]
    assert by_port.get_bundle("fleet").to_blob() == jreg.get("fleet")[1]
    assert by_ref.get_bundle("fleet").to_blob() == treg.get("fleet")[1]


# ---------------------------------------------------------------------------
# registry URIs
# ---------------------------------------------------------------------------
URIS = ["registry://h:80/fleet/abc123", "registry://h:80/fleet", "registry://h:80/fleet/", "registry://h:80",
        "registry:///fleet", "registry://h:80/a/b/c", "registry://127.0.0.1:8080/default/latest", "file:///x",
        "registry://", "registry://h:80//fleet//v1"]


def test_parse_registry_uri():
    assert parse_registry_uri("registry://h:80/fleet/abc123") == ("http://h:80", "fleet", "abc123")
    assert parse_registry_uri("registry://h:80/fleet") == ("http://h:80", "fleet", "latest")
    for bad in ("registry://h:80", "registry:///fleet", "file:///x"):
        with pytest.raises(BundleFormatError) as err:
            parse_registry_uri(bad)
        assert err.value.section == "uri"


@pytest.mark.parametrize("uri", URIS)
def test_parse_registry_uri_equal(uri):
    try:
        want = jax_bundle_mod.parse_registry_uri(uri)
    except jax_bundle_mod.BundleFormatError as e:
        with pytest.raises(BundleFormatError) as err:
            parse_registry_uri(uri)
        assert str(err.value) == str(e) and err.value.section == e.section == "uri"
    else:
        assert parse_registry_uri(uri) == want


def test_load_bundle_opens_registry_uri(plane, tuned_bundle):
    client = ControlPlaneClient(plane.url)
    _tune(client, "fleet")
    uri = client.registry_uri("fleet")
    assert uri.startswith("registry://") and uri.endswith("/fleet/latest")
    bundle = repro_torch.load_bundle(uri)
    assert bundle.to_blob() == tuned_bundle.to_blob()  # byte-identical payload
    # a plain http:// URL on the artifact route works too
    ver = plane.registry.latest("fleet").version
    direct = repro_torch.load_bundle(f"{plane.url}/artifacts/fleet/{ver}")
    assert direct.to_blob() == tuned_bundle.to_blob()
    with pytest.raises(BundleFormatError, match="HTTP 404") as err:
        repro_torch.load_bundle(client.registry_uri("fleet", "cafecafecafe"))
    assert err.value.section == "uri"


def test_load_bundle_unreachable_registry_raises():
    with pytest.raises(BundleFormatError) as err:
        DeploymentBundle.load("registry://127.0.0.1:9/missing/latest")
    assert err.value.section == "uri"


# ---------------------------------------------------------------------------
# job lifecycle over HTTP
# ---------------------------------------------------------------------------
def test_job_walks_queued_running_succeeded(plane):
    client = ControlPlaneClient(plane.url)
    job = client.submit({"kind": "tune", "name": "default"})
    assert job["state"] == "queued"
    done = client.wait_job(job["id"], timeout=60)
    assert done["state"] == "succeeded"
    assert [s for s, _t in done["history"]] == ["queued", "running", "succeeded"]
    ts = [t for _s, t in done["history"]]
    assert ts == sorted(ts)
    assert done["artifact"]["name"] == "default"
    assert done["artifact"]["version"] == plane.registry.latest("default").version
    assert done["artifact"]["devices"] == [CARD]


def test_crashing_tune_becomes_failed_job():
    def tuner(spec):
        raise RuntimeError("benchmark harness exploded")

    with ControlPlane(port=0, tuner=tuner) as plane:
        client = ControlPlaneClient(plane.url)
        job = client.submit({"kind": "tune"})
        done = client.wait_job(job["id"], timeout=60)
        assert done["state"] == "failed"
        assert "RuntimeError" in done["error"] and "exploded" in done["error"]
        assert [s for s, _t in done["history"]] == ["queued", "running", "failed"]
        assert done["artifact"] is None


def test_real_tune_job_on_the_cpu(tmp_path):
    """No seam: the plane runs tune_fleet on host_cpu (numpy-measured) and publishes it."""
    with ControlPlane(port=0, registry_root=tmp_path) as plane:
        client = ControlPlaneClient(plane.url)
        job = client.submit({"devices": ["host_cpu"], "archs": ["granite-8b"], "n_kernels": 3})
        done = client.wait_job(job["id"], timeout=120)
        assert done["state"] == "succeeded", done["error"]
        assert done["artifact"]["devices"] == ["host_cpu"]
        bundle = repro_torch.load_bundle(client.registry_uri("default"))
        assert bundle.devices == ["host_cpu"] and bundle.load_errors == []
        assert bundle.deployments["host_cpu"].meta["train_distribution"]
        assert client.policy("host_cpu", after=0, timeout=0.0)["version"] == done["artifact"]["version"]
    assert ArtifactRegistry(tmp_path).latest("default").version == done["artifact"]["version"]


def _direct_error(**kwargs) -> str:
    try:
        tuner.tune_fleet(["granite-8b"], **kwargs)
    except Exception as e:  # noqa: BLE001 — the message a failed job must carry
        return f"{type(e).__name__}: {e}"
    raise AssertionError(f"tune_fleet({kwargs}) did not raise")


@pytest.mark.parametrize("spec, want", [
    ({"devices": ["host_cpu"], "transfer": True}, lambda: f"ValueError: {tuner.TRANSFER_REFUSED}"),
    ({"devices": ["tpu_v5e"]}, lambda: _direct_error(device_names=("tpu_v5e",), n_kernels=3)),
    ({"devices": [CARD, "gpu_nvidia_a100_sxm4_80gb"]},
     lambda: _direct_error(device_names=(CARD, "gpu_nvidia_a100_sxm4_80gb"), n_kernels=3)),
])
def test_refused_specs_fail_with_their_messages(spec, want):
    """A transfer spec fails with the tune CLI's message, a device this host cannot measure
    with tune_fleet's own, never a TypeError."""
    with ControlPlane(port=0) as plane:
        client = ControlPlaneClient(plane.url)
        done = client.wait_job(client.submit({"archs": ["granite-8b"], "n_kernels": 3, **spec})["id"], timeout=60)
    assert done["state"] == "failed" and done["error"] == want()
    assert "TypeError" not in done["error"]


def test_bad_specs_and_unknown_routes(plane):
    client = ControlPlaneClient(plane.url)
    with pytest.raises(ControlPlaneError, match="400"):
        client.submit({"kind": "mystery"})
    with pytest.raises(ControlPlaneError, match="400"):
        client.submit({"kind": "retune"})  # no device
    with pytest.raises(ControlPlaneError, match="404"):
        client.job("job-9999")
    with pytest.raises(ControlPlaneError, match="404"):
        client.artifact("never-published")
    with pytest.raises(ControlPlaneError, match="404"):
        client._request("GET", "/nowhere")
    with pytest.raises(ControlPlaneError, match="404"):
        client._request("POST", "/nowhere", {})


def test_health_counts_jobs_and_artifacts(plane):
    client = ControlPlaneClient(plane.url)
    _tune(client)
    health = client.healthz()
    assert health["status"] == "ok"
    assert health["jobs"]["succeeded"] >= 1
    assert health["artifacts"]["default"] == 1
    assert health["uptime_s"] >= 0
    assert health["devices"] == [CARD]


# ---------------------------------------------------------------------------
# telemetry federation -> drift -> retune -> policy push
# ---------------------------------------------------------------------------
def test_federation_merges_and_triggers_once_over_min_events(plane):
    client = ControlPlaneClient(plane.url)
    _tune(client)
    ack1 = client.post_telemetry(CARD, _shifted_snapshot(6, seed=1), host="h1")
    assert ack1["merged_events"] == 6 and ack1["hosts"] == 1
    assert ack1["retune_job"] is None  # under the min-events floor
    assert not any(r["triggered"] for r in ack1["drift"].values())

    ack2 = client.post_telemetry(CARD, _shifted_snapshot(6, seed=2), host="h2")
    assert ack2["merged_events"] == 12 and ack2["hosts"] == 2
    assert ack2["drift"]["matmul"]["triggered"]
    assert ack2["retune_job"] is not None

    # a third post while the retune is pending does not double-schedule
    ack3 = client.post_telemetry(CARD, _shifted_snapshot(6, seed=3), host="h3")
    done = client.wait_job(ack2["retune_job"], timeout=120)
    assert ack3["retune_job"] in (None, ack2["retune_job"])
    assert done["state"] == "succeeded", done["error"]
    art = done["artifact"]
    assert art["parent"] == plane.registry.versions("default")[0].version
    assert art["families"] == ["matmul"] and art["device"] == CARD
    assert len(plane.registry.versions("default")) == 2
    assert [j["kind"] for j in client.jobs()].count("retune") == 1


def test_retune_without_telemetry_fails(plane):
    client = ControlPlaneClient(plane.url)
    _tune(client)
    bad = client.submit({"kind": "retune", "device": CARD})
    done = client.wait_job(bad["id"], timeout=60)
    assert done["state"] == "failed"
    assert "telemetry" in done["error"]


def test_policy_longpoll_delivers_and_times_out(plane):
    client = ControlPlaneClient(plane.url)
    assert client.policy(CARD, after=0, timeout=0.0) is None  # 204: empty board
    job = client.submit({"kind": "tune", "name": "default"})
    client.wait_job(job["id"], timeout=60)
    ent = client.policy(CARD, after=0, timeout=5.0)
    assert ent["seq"] == 1 and ent["job"] == job["id"]
    assert ent["version"] == plane.registry.latest("default").version
    t0 = time.monotonic()
    assert client.policy(CARD, after=ent["seq"], timeout=0.3) is None  # timed out: 204
    assert time.monotonic() - t0 >= 0.25

    # a parked long-poll wakes when the board advances
    got = {}

    def poll():
        got["ent"] = client.policy(CARD, after=ent["seq"], timeout=20.0)

    t = threading.Thread(target=poll)
    t.start()
    time.sleep(0.2)
    client.post_telemetry(CARD, _shifted_snapshot(40), host="h1")
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert got["ent"] is not None and got["ent"]["seq"] == 2


def test_stop_wakes_parked_long_polls(tuned_bundle):
    p = ControlPlane(port=0, tuner=lambda spec: tuned_bundle).start()
    got = {}

    def poll():
        got["ent"] = p.wait_policy(CARD, after=0, timeout=30.0)

    t = threading.Thread(target=poll)
    t.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    p.stop()
    t.join(timeout=5.0)
    assert not t.is_alive() and got["ent"] is None
    assert time.monotonic() - t0 < 5.0


def test_subscriber_applies_policy_to_runtime(plane, tuned_bundle):
    client = ControlPlaneClient(plane.url)
    _tune(client)
    rt = tuned_bundle.runtime(device=CARD, name="sub-test")
    epoch0 = rt.policy_epoch()
    with PolicySubscriber(client, CARD, rt, poll_timeout=POLL) as sub:
        # start_from="current" skips the bring-up announcement...
        time.sleep(0.3)
        assert sub.updates == []
        # ...and delivers the retune announcement that follows
        ack = client.post_telemetry(CARD, _shifted_snapshot(40), host="h1")
        client.wait_job(ack["retune_job"], timeout=120)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not sub.updates:
            time.sleep(0.05)
    assert sub.errors == []
    assert [u["seq"] for u in sub.updates] == [2]
    assert sub.updates[0]["version"] == plane.registry.latest("default").version
    assert rt.policy_epoch() > epoch0  # hot-swapped into the live registry
    want = plane.registry.get_bundle("default").deployments[CARD]
    assert rt.policy().to_blob() == want.to_blob()


def test_subscriber_from_zero_replays_the_newest_entry(plane, tuned_bundle):
    client = ControlPlaneClient(plane.url)
    done = _tune(client)
    rt = KernelRuntime(name="replay")
    with PolicySubscriber(client, CARD, rt, start_from=0, poll_timeout=POLL) as sub:
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not sub.updates:
            time.sleep(0.05)
    assert sub.errors == [] and [u["version"] for u in sub.updates] == [done["artifact"]["version"]]
    assert rt.active_device() == CARD and rt.policy().to_blob() == tuned_bundle.deployments[CARD].to_blob()


def test_runtime_apply_policy_update_targets_device(tuned_bundle):
    rt = tuned_bundle.runtime(device=CARD, name="apply-test")
    dep, _ = tuned_bundle.deployment_for(CARD)
    epoch = rt.policy_epoch()
    assert rt.apply_policy_update(dep.clone(), CARD) == CARD
    assert rt.active_device() == CARD and rt.policy_epoch() > epoch
    assert KernelRuntime().apply_policy_update(dep) is None  # no target device: a direct install


def test_apply_policy_update_refuses_uncompiled_configs_on_a_cuda_target(tuned_bundle, tpu_bundles):
    """A TPU tune's configs are outside the port's compiled space: a gpu_* target refuses
    them before anything is installed; a CPU target installs them (selections only)."""
    rt = tuned_bundle.runtime(device=CARD, name="refuse")
    live, epoch = rt.policy(), rt.policy_epoch()
    tpu_dep = DeploymentBundle.load(tpu_bundles[0]).deployments["tpu_v5e"]
    with pytest.raises(ValueError, match="compiled space"):
        rt.apply_policy_update(tpu_dep, CARD)
    assert rt.policy() is live and rt.policy_epoch() == epoch
    assert KernelRuntime().apply_policy_update(tpu_dep, "tpu_v5e") == "tpu_v5e"


def test_subscriber_records_a_refused_delivery(tuned_bundle, tpu_bundles):
    """A pushed deployment the runtime refuses (uncompiled configs for the card) is an
    error of the subscriber; the live policy stays."""
    tpu_dep = DeploymentBundle.load(tpu_bundles[0]).deployments["tpu_v5e"]
    rt = tuned_bundle.runtime(device=CARD, name="refused-push")
    live = rt.policy()
    with ControlPlane(port=0, tuner=lambda spec: DeploymentBundle({CARD: tpu_dep})) as plane:
        client = ControlPlaneClient(plane.url)
        with PolicySubscriber(client, CARD, rt, poll_timeout=POLL) as sub:
            time.sleep(0.3)
            _tune(client)
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline and not sub.errors:
                time.sleep(0.05)
    assert sub.updates == [] and len(sub.errors) == 1 and "compiled space" in sub.errors[0]
    assert rt.policy() is live


# ---------------------------------------------------------------------------
# HTTP edges
# ---------------------------------------------------------------------------
def test_telemetry_post_requires_device_and_snapshot(plane):
    client = ControlPlaneClient(plane.url)
    with pytest.raises(ControlPlaneError, match="400"):
        client._request("POST", "/telemetry", {"device": CARD})
    with pytest.raises(ControlPlaneError, match="400"):
        client._request("POST", "/telemetry", {"snapshot": {}})


def test_artifact_envelope_shape(plane):
    client = ControlPlaneClient(plane.url)
    _tune(client)
    env = client.artifact("default")
    assert env["format"] == "artifact"
    assert env["version"] == content_version(env["blob"])
    assert json.dumps(env)  # the whole envelope is JSON-serializable
    assert env["lineage"]["spec"]["name"] == "default"
    assert set(env) == {"format", "name", "version", "seq", "created", "lineage", "blob"}


# ---------------------------------------------------------------------------
# held against the reference's plane and client
# ---------------------------------------------------------------------------
def _planes(tpu_bundles, **kw):
    """(reference plane, port plane), started, each holding the same bundle as 'default'."""
    jplane = jax_control.ControlPlane(port=0, **kw).start()
    tplane = ControlPlane(port=0, retune_dataset_builder=_port_table, **kw).start()
    jplane.registry.publish("default", JaxBundle.load(tpu_bundles[0]))
    tplane.registry.publish("default", DeploymentBundle.load(tpu_bundles[0]))
    return jplane, tplane


def _same_ack(got: dict, want: dict) -> None:
    assert (got["device"], got["merged_events"], got["hosts"]) == (want["device"], want["merged_events"],
                                                                    want["hosts"])
    assert set(got["drift"]) == set(want["drift"])
    for fam, r in want["drift"].items():
        assert abs(got["drift"][fam]["score"] - r["score"]) <= 1e-9
        assert (got["drift"][fam]["triggered"], got["drift"][fam]["n_events"]) == (r["triggered"], r["n_events"])
    assert (got["retune_job"] is None) == (want["retune_job"] is None)


@pytest.mark.parametrize("min_events, sizes", [(10, (6, 6)), (32, (20, 8, 20))])
def test_federation_verdicts_equal(tpu_bundles, min_events, sizes):
    """The same posts to both planes: equal acks up to the trigger, the same retuned child,
    and after it (a fresh window, judged against the child) equal acks again."""
    jplane, tplane = _planes(tpu_bundles, min_events=min_events)
    try:
        assert jplane.registry.latest("default").version == tplane.registry.latest("default").version
        jclient, tclient = jax_control.ControlPlaneClient(jplane.url), ControlPlaneClient(tplane.url)

        def post(n, seed):
            wire = _shifted_snapshot(n, seed=seed).to_json()
            want = jclient.post_telemetry("tpu_v5e", wire, host=f"h{seed % 2}")
            got = tclient.post_telemetry("tpu_v5e", wire, host=f"h{seed % 2}")
            _same_ack(got, want)
            return want, got

        acks = [post(n, i + 1) for i, n in enumerate(sizes)]
        fired = [(w["retune_job"], g["retune_job"]) for w, g in acks if w["retune_job"]]
        assert len(fired) == 1 and acks[-1][0]["retune_job"]  # one trigger, on the last post
        jdone, tdone = jclient.wait_job(fired[0][0], timeout=120), tclient.wait_job(fired[0][1], timeout=120)
        assert jdone["state"] == tdone["state"] == "succeeded", (jdone["error"], tdone["error"])
        assert {k: v for k, v in tdone["artifact"].items() if k != "version"} == {
            k: v for k, v in jdone["artifact"].items() if k != "version"}
        jdep = jplane.registry.get_bundle("default").deployments["tpu_v5e"]
        tdep = tplane.registry.get_bundle("default").deployments["tpu_v5e"]
        assert [c.name() for c in tdep.configs] == [c.name() for c in jdep.configs]
        assert tdep.meta["retune_log"] == jdep.meta["retune_log"]
        assert [r.lineage["parent"] for r in tplane.registry.versions("default")] == [
            None, tplane.registry.versions("default")[0].version]
        post(4, 9)  # judged against each plane's child
    finally:
        jplane.stop()
        tplane.stop()


def _cross_check(client, bundle_cls, load_bundle, snapshot, ref_blob):
    """One client against one plane (tuner seam): submit, wait, fetch, load by URI,
    post telemetry, long-poll."""
    job = client.submit({"kind": "tune", "name": "fleet"})
    assert job["state"] == "queued"
    done = client.wait_job(job["id"], timeout=60)
    assert done["state"] == "succeeded" and [s for s, _ in done["history"]] == ["queued", "running", "succeeded"]
    fetched = client.fetch_bundle("fleet")
    assert isinstance(fetched, bundle_cls) and fetched.to_blob() == ref_blob
    assert load_bundle(client.registry_uri("fleet")).to_blob() == ref_blob
    ent = client.policy("tpu_v5e", after=0, timeout=2.0)
    assert ent["seq"] == 1 and ent["version"] == done["artifact"]["version"] == content_version(ref_blob)
    assert client.policy("tpu_v5e", after=1, timeout=0.2) is None
    ack = client.post_telemetry("tpu_v5e", snapshot, host="h1", artifact="fleet")
    assert ack["merged_events"] == snapshot.n_events and ack["hosts"] == 1
    assert client.healthz()["artifacts"] == {"fleet": 1}
    return ack


def test_port_client_against_the_reference_plane(tpu_bundles):
    ref_bundle = JaxBundle.load(tpu_bundles[0])
    with jax_control.ControlPlane(port=0, min_events=10**6, tuner=lambda spec: ref_bundle) as plane:
        _cross_check(ControlPlaneClient(plane.url), DeploymentBundle, repro_torch.load_bundle,
                     _shifted_snapshot(12), ref_bundle.to_blob())


def test_reference_client_against_the_port_plane(tpu_bundles):
    import repro

    port_bundle = DeploymentBundle.load(tpu_bundles[0])
    with ControlPlane(port=0, min_events=10**6, tuner=lambda spec: port_bundle) as plane:
        _cross_check(jax_control.ControlPlaneClient(plane.url), JaxBundle, repro.load_bundle,
                     _shifted_snapshot(12, snap_cls=jax_retune.TelemetrySnapshot), port_bundle.to_blob())


def test_subscribers_on_cpu_engines_adopt_equal(tpu_bundles):
    """One port plane announces the second bundle; each package's engine (the same reduced
    granite-8b, serving the first bundle) is subscribed through its own client and
    adopts at its next step boundary; the streams after the swap are equal."""
    jm, jp, tm, tp = reduced_pair("granite-8b")
    jeng = JaxEngine(jm, jp, runtime=JaxRuntime(name="sub"), bundle=tpu_bundles[0], device="tpu_v5e",
                     max_batch=2, cache_len=128)
    teng = ServingEngine(tm, tp, runtime=KernelRuntime(name="sub"), bundle=tpu_bundles[0], device="tpu_v5e",
                         max_batch=2, cache_len=128, retune_dataset_builder=_port_table)
    rng = np.random.default_rng(24)
    prompts = [rng.integers(1, tm.cfg.vocab, n).astype(np.int32) for n in (8, 30, 14)]
    jt = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=5) for p in prompts]
    for eng in (jeng, teng):
        eng.step()
        eng.step()
    pushed = DeploymentBundle.load(tpu_bundles[1])
    with ControlPlane(port=0, tuner=lambda spec: pushed) as plane:
        jsub = jax_control.PolicySubscriber(jax_control.ControlPlaneClient(plane.url), "tpu_v5e", jeng,
                                            poll_timeout=POLL).start()
        tsub = PolicySubscriber(ControlPlaneClient(plane.url), "tpu_v5e", teng, poll_timeout=POLL).start()
        time.sleep(0.3)
        ControlPlaneClient(plane.url).wait_job(plane.submit_job({"kind": "tune"}).id, timeout=60)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not (jsub.updates and tsub.updates):
            time.sleep(0.05)
        jsub.stop()
        tsub.stop()
    assert jsub.errors == tsub.errors == [] and len(jsub.updates) == len(tsub.updates) == 1
    epoch0 = teng.runtime.policy_epoch()
    js, ts = jeng.drain(), teng.drain()
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert (ts.completed, ts.steps) == (js.completed, js.steps) == (3, ts.steps)
    tev, jev = teng.retune_events[0], jeng.retune_events[0]
    assert (tev.source, tev.swapped, tev.step) == (jev.source, jev.swapped, jev.step) == ("control-plane", True, 2)
    assert teng.deployment.to_blob() == pushed.deployments["tpu_v5e"].to_blob()
    assert min(v["epoch"] for v in teng.programs().values()) > epoch0  # built again under the pushed policy
    assert teng.runtime.policy_epoch() == jeng.runtime.policy_epoch()
