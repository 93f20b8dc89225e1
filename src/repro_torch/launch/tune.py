"""Tuning CLI: a shippable kernel deployment (or multi-device bundle) from the card.

The operator tool for bringing up a card (the paper's zero-developer-effort
pitch), run on the card itself:

  python -m repro_torch.launch.tune --out build/deploy_h100.json
  python -m repro_torch.launch.tune --archs granite-8b,hymba-1.5b --out deploy.json
  python -m repro_torch.launch.tune --devices gpu_nvidia_h100_80gb_hbm3,host_cpu \\
      --bundle build/bundle_h100.json

It measures the benchmark tables on the card with the port's own kernels
(every compiled config of every family on the problems the architectures
launch; see ``core/gpubench.py``), runs the paper's pipeline on them
(normalize, cluster-select ``--n-kernels`` matmul configs, fit the decision
trees), and writes the ``Deployment`` (v5 JSON) or, with ``--bundle``, a v6
``DeploymentBundle`` of one Deployment per ``--devices`` entry (default:
this card and ``host_cpu``, which is measured with numpy,
``core/cpubench.py``).  It prints each family's deployed configs, table,
seconds and oracle / classifier fractions.  ``--families`` (default: every
registered family) restricts the families tuned beyond matmul.

The staged pipeline (``core/pipeline.py``) brings a card up cheaply:
``--transfer-from deploy.json`` warm-starts every family from an earlier
deployment and measures only where the H100 model and the donor disagree,
``--prune-ratio 0.5`` drops the half of each config space the model rules
out before anything is measured, and ``--measure-budget 0.3`` caps the
measured cells at 30% of a full harvest (``auto``: sized per family from
the donor's recorded ``model_error``).  The reference's fleet-mode
``--transfer`` (each card warm-started from a tuned sibling card) is
refused: a fleet here holds one card, this host's.

With both ``--bundle`` and ``--out``, the fleet tune runs once and the
card's Deployment from it (``--device``, default the card) is also
written to ``--out``.

A serving host installs the artifact with ``--deployment`` / ``--bundle`` of
``repro_torch.launch.serve``, ``rt.install(Deployment.load(path))`` or
``repro_torch.load_bundle(path).runtime()``.  With no CUDA device a card
tune raises: the tables are the card's own; ``--device host_cpu`` needs no
card.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import registry
from ..core.cluster import CLUSTER_METHODS
from ..core.codegen import tree_to_python
from ..core.devices import canonical_device_name
from ..core.families import family_names, get_family
from ..core.normalize import NORMALIZATIONS
from ..core.tuner import DEFAULT_MAX_PROBLEMS, save_fleet, save_result, tune, tune_fleet, tune_for_archs


def _measure_budget(text: str):
    """argparse type for --measure-budget: a fraction in (0, 1) or 'auto'."""
    if text.strip().lower() == "auto":
        return "auto"
    try:
        val = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a fraction in (0, 1) or 'auto', got {text!r}") from None
    if not 0.0 < val < 1.0:
        raise argparse.ArgumentTypeError(f"must be a fraction in (0, 1) or 'auto', got {val}")
    return val


def _no_card() -> RuntimeError:
    return RuntimeError(
        "torch finds no CUDA device: the tuning tables are measured on the card "
        "with the port's kernels, so a card tunes only there"
    )


def _print_result(result, label: str) -> None:
    """Each family's table, seconds, deployed configs, fractions and staged cost."""
    dep = result.deployment
    lineage = dep.meta.get("tuning_lineage") or {}
    tables = dep.meta.get("tables") or {}
    seconds = dep.meta.get("measure_seconds") or {}
    fractions = {"matmul": (result.oracle_fraction, result.classifier_fraction)} | {
        name: (r.oracle_fraction, r.classifier_fraction) for name, r in result.family_results.items()}
    for fname in ["matmul", *result.family_results]:
        configs, _tree = dep.family_tuning(fname)
        oracle, clf = fractions[fname]
        rec = lineage.get(fname) or {}
        table = f"table {tables[fname][0]} problems x {tables[fname][1]} configs, " if fname in tables else ""
        secs = f"measured in {seconds[fname]:.1f}s; " if fname in seconds else ""
        staged = ""
        if rec.get("measured_fraction", 1.0) < 1.0 or rec.get("source_device"):
            err = rec.get("model_error")
            staged = (f"; staged: {rec['n_measured']}/{rec['full_cost']} cells measured "
                      f"({rec['measured_fraction']:.1%}), kept {rec['prune_ratio']:.0%} of the space, donor "
                      f"{rec.get('source_device') or 'none'}, model error "
                      f"{'n/a' if err is None else f'{err:.3f}'}")
        print(f"  [{label}] {fname:9s} {table}{secs}deployed {[c.name() for c in configs]}; "
              f"oracle {oracle:.1%} / classifier {clf:.1%}{staged}")


def main(argv=None):
    """Tune; returns the ``TuneResult`` (``--out`` alone) or the ``FleetTuneResult`` (``--bundle``)."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="device to tune for --out: this card (the default) or host_cpu")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device names to tune into one bundle (fleet mode; "
                         "default: this card and host_cpu)")
    ap.add_argument("--archs", default=None, help="comma-separated arch ids (default: all the port registers)")
    ap.add_argument("--families", default=None,
                    help="comma-separated kernel families to tune beyond matmul "
                         "(default: every registered family; '' tunes matmul only)")
    ap.add_argument("--n-kernels", type=int, default=8, help="matmul configs to deploy")
    ap.add_argument("--method", default="pca_kmeans", choices=CLUSTER_METHODS)
    ap.add_argument("--normalization", default="standard", choices=NORMALIZATIONS)
    ap.add_argument("--classifier", default="DecisionTreeA")
    ap.add_argument("--max-problems", type=int, default=DEFAULT_MAX_PROBLEMS,
                    help="cap on the GEMM problems (a seeded subsample above it)")
    ap.add_argument("--cpu-problems", type=int, default=24, help="GEMM problems host_cpu measures")
    ap.add_argument("--out", default=None, help="single-device deployment output path")
    ap.add_argument("--bundle", default=None, help="multi-device bundle output path")
    ap.add_argument("--transfer-from", default=None, metavar="DEPLOY_JSON",
                    help="warm-start from an earlier deployment of this card: reuse its kernel "
                         "subsets as clustering seeds and measure only where the H100 model and "
                         "it disagree (single-device mode)")
    ap.add_argument("--transfer", action="store_true",
                    help="the reference's fleet-mode card-to-card warm start; refused here, where a "
                         "fleet holds only this host's card (use --transfer-from)")
    ap.add_argument("--prune-ratio", type=float, default=None, metavar="R",
                    help="keep only the top R (0<R<1) of each config space by predicted perf "
                         "before measuring anything")
    ap.add_argument("--measure-budget", type=_measure_budget, default=None, metavar="B",
                    help="measure at most B (0<B<1) of the full harvest's cells; the rest is "
                         "filled from the H100 model.  'auto' sizes B per family from the "
                         "donor's recorded model_error (donor-less tunes measure in full)")
    args = ap.parse_args(argv)

    if not args.out and not args.bundle:
        ap.error("one of --out / --bundle is required")
    if args.devices and not args.bundle:
        ap.error("--devices selects fleet mode and requires --bundle <path>")
    if args.prune_ratio is not None and not 0.0 < args.prune_ratio < 1.0:
        ap.error(f"--prune-ratio must be a fraction in (0, 1), got {args.prune_ratio}")
    if args.transfer:
        ap.error("--transfer warm-starts each card from another tuned card, but a fleet holds only this "
                 "host's card (another card's tables cannot be measured here); warm-start from an earlier "
                 "deployment of this card with --transfer-from")
    if args.transfer_from and args.device == "host_cpu":
        ap.error("--transfer-from does not apply to host_cpu (it always measures)")
    archs = args.archs.split(",") if args.archs else None
    for a in archs or ():
        registry.get(a)  # validate early
    families = family_names()
    if args.families is not None:
        families = [f for f in args.families.replace(" ", "").split(",") if f]
    for f in families:
        get_family(f)  # validate early
    transfer_prior = None
    if args.transfer_from:
        from ..core.dispatch import Deployment

        transfer_prior = Deployment.load(args.transfer_from)

    t0 = time.perf_counter()
    fleet = None
    if args.bundle:
        device_names = tuple(args.devices.replace(" ", "").split(",")) if args.devices else None
        if any(d != "host_cpu" for d in device_names or ("card",)) and not torch.cuda.is_available():
            raise _no_card()
        fleet = tune_fleet(
            archs, device_names=device_names, n_kernels=args.n_kernels, method=args.method,
            normalization=args.normalization, classifier=args.classifier,
            max_problems=args.max_problems, cpu_problems=args.cpu_problems, families=families,
            prune_ratio=args.prune_ratio, measure_budget=args.measure_budget,
        )
        save_fleet(fleet, args.bundle)
        print(f"bundle ({len(fleet.results)} devices) -> {args.bundle} ({time.perf_counter() - t0:.1f}s)")
        for name, res in sorted(fleet.results.items()):
            print(f"  {name}: oracle {res.oracle_fraction:.1%} / classifier {res.classifier_fraction:.1%} "
                  f"(families: {', '.join(res.deployment.family_names())})")
            _print_result(res, name)
        # Prove the saved artifact serves: load it back into a fresh runtime (checksums
        # verified) and dispatch one probe selection against the first device.
        from .. import load_bundle

        loaded = load_bundle(args.bundle)
        if loaded.load_errors:
            raise SystemExit(f"bundle verification failed: {args.bundle}: {loaded.load_errors}")
        first = sorted(fleet.results)[0] if device_names is None else device_names[0]
        rt = loaded.runtime(device=first)
        probe = rt.select_matmul_config(512, 784, 512, 16)
        if probe is None:
            raise SystemExit(f"bundle verification failed: {args.bundle} loaded into {rt!r} "
                             f"but served no probe selection")
        print(f"verified: {rt!r} serves (probe matmul -> {probe.name()})")
        if args.out:
            # The fleet already tuned the card: save its run, do not tune again.
            cards = [d for d in fleet.results if d != "host_cpu"]
            out_device = canonical_device_name(args.device) if args.device else (cards[0] if cards else "host_cpu")
            if out_device not in fleet.results:
                raise SystemExit(f"--out names {out_device!r}, which the fleet {sorted(fleet.results)} did not tune")
            save_result(fleet.results[out_device], args.out)
            print(f"deployment for {out_device} -> {args.out} (from the fleet tune)")
        return fleet
    if args.device == "host_cpu":
        from ..core.cpubench import build_cpu_dataset, cpu_problems

        print(f"measuring {args.cpu_problems} problems x {len(get_family('matmul').config_space())} configs "
              f"on this host (numpy)...")
        ds = build_cpu_dataset(cpu_problems(args.cpu_problems), verbose=True)
        result = tune(ds, n_kernels=args.n_kernels, method=args.method, normalization=args.normalization,
                      classifier=args.classifier, arch_ids=archs, families=[])
    else:
        if not torch.cuda.is_available():
            raise _no_card()
        result = tune_for_archs(
            archs, device_name=args.device, n_kernels=args.n_kernels, method=args.method,
            normalization=args.normalization, classifier=args.classifier, max_problems=args.max_problems,
            families=families, transfer_from=transfer_prior, prune_ratio=args.prune_ratio,
            measure_budget=args.measure_budget,
        )
    save_result(result, args.out)
    dep = result.deployment
    print(f"deployment for {dep.device} -> {args.out} ({time.perf_counter() - t0:.1f}s)")
    _print_result(result, dep.device)
    print("--- generated launcher (first lines) ---")
    print("\n".join(tree_to_python(dep.classifier).splitlines()[:8]))
    return result


if __name__ == "__main__":
    main()
