"""Control-plane CLI: run the tuning service, submit jobs, inspect state.

Ported from ``repro/launch/ctl.py``: the operator tool for the fleet-wide
tuning loop (DESIGN.md §14), with the reference's commands and output::

  # run the service (artifacts persisted under --registry-root)
  python -m repro_torch.launch.ctl serve --port 8080 --registry-root build/registry

  # submit a tune over HTTP (measured on the plane's card) and wait for the artifact
  python -m repro_torch.launch.ctl submit --url http://host:8080 \\
      --archs granite-8b --measure-budget auto --wait

  # job + artifact + health inspection
  python -m repro_torch.launch.ctl status --url http://host:8080 [--job job-0001]
  python -m repro_torch.launch.ctl artifacts --url http://host:8080 [--name default]

A job naming no device tunes the plane's default fleet (its card and
``host_cpu``); ``--transfer`` is accepted and the job fails, as the tune CLI
refuses it.  A serving host consumes the produced artifact with
``repro_torch.load_bundle("registry://host:8080/default")`` and stays current
by attaching a :class:`repro_torch.control.PolicySubscriber` to its engine.
"""
from __future__ import annotations

import argparse
import json

from ..control import ControlPlane, ControlPlaneClient
from ..core.retune import DEFAULT_DRIFT_THRESHOLD, DEFAULT_MIN_EVENTS
from .tune import _measure_budget


def _cmd_serve(args) -> None:
    plane = ControlPlane(
        host=args.host, port=args.port, registry_root=args.registry_root,
        drift_threshold=args.drift_threshold, min_events=args.min_events,
    )
    plane.start()
    print(f"control plane listening on {plane.url}")
    if args.registry_root:
        print(f"artifacts persisted under {args.registry_root}")
    try:
        import signal
        import threading

        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        stop.wait()
    finally:
        plane.stop()
        print("control plane stopped")


def _cmd_submit(args) -> None:
    client = ControlPlaneClient(args.url)
    spec: dict = {"kind": "tune", "name": args.name}
    if args.devices:
        spec["devices"] = args.devices.replace(" ", "").split(",")
    if args.archs:
        spec["archs"] = args.archs.replace(" ", "").split(",")
    if args.families:
        spec["families"] = args.families.replace(" ", "").split(",")
    if args.transfer:
        spec["transfer"] = True
    if args.prune_ratio is not None:
        spec["prune_ratio"] = args.prune_ratio
    if args.measure_budget is not None:
        spec["measure_budget"] = args.measure_budget
    if args.n_kernels is not None:
        spec["n_kernels"] = args.n_kernels
    if args.max_problems is not None:
        spec["max_problems"] = args.max_problems
    job = client.submit(spec)
    print(f"{job['id']} {job['state']}")
    if not args.wait:
        return
    done = client.wait_job(job["id"], timeout=args.timeout)
    print(f"{done['id']} {done['state']}"
          + (f": {done['error']}" if done.get("error") else ""))
    if done["state"] == "succeeded":
        art = done["artifact"]
        print(f"artifact {art['name']}@{art['version']} "
              f"(registry://{args.url.split('://', 1)[-1]}/{art['name']}/{art['version']})")
    else:
        raise SystemExit(1)


def _cmd_status(args) -> None:
    client = ControlPlaneClient(args.url)
    if args.job:
        print(json.dumps(client.job(args.job), indent=1))
        return
    print(json.dumps(client.healthz(), indent=1))
    for job in client.jobs():
        line = f"{job['id']} [{job['kind']}] {job['state']}"
        if job.get("artifact"):
            line += f" -> {job['artifact']['name']}@{job['artifact']['version']}"
        if job.get("error"):
            line += f" ({job['error']})"
        print(line)


def _cmd_artifacts(args) -> None:
    client = ControlPlaneClient(args.url)
    arts = client.artifacts()
    names = [args.name] if args.name else sorted(arts)
    for name in names:
        for rec in arts.get(name, []):
            lineage = rec.get("lineage") or {}
            parent = lineage.get("parent")
            print(f"{name}@{rec['version']} seq={rec['seq']}"
                  + (f" parent={parent}" if parent else ""))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    serve = sub.add_parser("serve", help="run the control-plane service")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8080)
    serve.add_argument("--registry-root", default=None,
                       help="directory to persist published artifacts (default: in-memory)")
    serve.add_argument("--drift-threshold", type=float, default=DEFAULT_DRIFT_THRESHOLD)
    serve.add_argument("--min-events", type=int, default=DEFAULT_MIN_EVENTS)
    serve.set_defaults(func=_cmd_serve)

    submit = sub.add_parser("submit", help="submit a bring-up tune job")
    submit.add_argument("--url", required=True, help="control-plane base URL")
    submit.add_argument("--name", default="default", help="artifact name to publish")
    submit.add_argument("--devices", default=None,
                        help="comma-separated devices (default: the plane's card and host_cpu)")
    submit.add_argument("--archs", default=None)
    submit.add_argument("--families", default=None)
    submit.add_argument("--transfer", action="store_true",
                        help="the reference's card-to-card warm start; the job fails here (one card a fleet)")
    submit.add_argument("--prune-ratio", type=float, default=None)
    submit.add_argument("--measure-budget", type=_measure_budget, default=None,
                        help="fraction in (0,1) or 'auto' (donor-lineage sized)")
    submit.add_argument("--n-kernels", type=int, default=None)
    submit.add_argument("--max-problems", type=int, default=None)
    submit.add_argument("--wait", action="store_true",
                        help="poll the job to a terminal state")
    submit.add_argument("--timeout", type=float, default=1800.0)
    submit.set_defaults(func=_cmd_submit)

    status = sub.add_parser("status", help="service health + job states")
    status.add_argument("--url", required=True)
    status.add_argument("--job", default=None, help="show one job in full")
    status.set_defaults(func=_cmd_status)

    artifacts = sub.add_parser("artifacts", help="list published artifact versions")
    artifacts.add_argument("--url", required=True)
    artifacts.add_argument("--name", default=None)
    artifacts.set_defaults(func=_cmd_artifacts)

    args = ap.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
