"""Tuning CLI: ``python -m repro_torch.launch.tune --out deploy.json [...]``.

The operator tool for bringing up a card (the paper's zero-developer-effort
pitch), run on the card itself:

  python -m repro_torch.launch.tune --archs granite-8b,hymba-1.5b \\
      --families attention --n-kernels 4 --out build/deploy_h100.json

It measures the benchmark tables on the card with the port's own kernels
(every compiled GEMM config on every harvested GEMM problem, and every
compiled config of each requested family on its harvest; see
``core/gpubench.py``), runs the paper's pipeline on them (normalize,
cluster-select ``--n-kernels`` matmul configs, fit the decision tree), and
writes the ``Deployment`` (v5 JSON).  It prints each family's deployed
configs, the oracle and classifier fractions, and the first lines of the
generated launcher.  A serving host installs the file with
``rt.install(Deployment.load(path))``.

``--families`` (default ``attention``, the non-matmul families with a
measured H100 source) names the families tuned beyond matmul; ``wkv`` and
``ssm_scan`` raise until their tables exist.  With no CUDA device it raises:
the tables are the card's own.  ``--device``, ``--devices``, ``--bundle``
and the transfer, prune and budget flags of the reference CLI join with
their slices.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import registry
from ..core.cluster import CLUSTER_METHODS
from ..core.codegen import tree_to_python
from ..core.families import get_family
from ..core.normalize import NORMALIZATIONS
from ..core.pipeline import DEFAULT_FAMILIES
from ..core.tuner import DEFAULT_MAX_PROBLEMS, TuneResult, save_result, tune_for_archs


def main(argv=None) -> TuneResult:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archs", default=None, help="comma-separated arch ids (default: all the port registers)")
    ap.add_argument("--families", default=",".join(DEFAULT_FAMILIES),
                    help="comma-separated kernel families to tune beyond matmul "
                         "(default: %(default)s; '' tunes matmul only)")
    ap.add_argument("--n-kernels", type=int, default=8, help="matmul configs to deploy")
    ap.add_argument("--method", default="pca_kmeans", choices=CLUSTER_METHODS)
    ap.add_argument("--normalization", default="standard", choices=NORMALIZATIONS)
    ap.add_argument("--classifier", default="DecisionTreeA")
    ap.add_argument("--max-problems", type=int, default=DEFAULT_MAX_PROBLEMS,
                    help="cap on the GEMM problems (a seeded subsample above it)")
    ap.add_argument("--out", required=True, help="deployment output path")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch finds no CUDA device: the tuning tables are measured on the card "
            "with the port's kernels, so tuning runs only there"
        )
    archs = args.archs.split(",") if args.archs else None
    for a in archs or ():
        registry.get(a)  # validate early
    families = [f for f in args.families.replace(" ", "").split(",") if f]
    for f in families:
        get_family(f)  # validate early

    t0 = time.perf_counter()
    result = tune_for_archs(
        archs, n_kernels=args.n_kernels, method=args.method, normalization=args.normalization,
        classifier=args.classifier, max_problems=args.max_problems, families=families,
    )
    save_result(result, args.out)
    dep = result.deployment
    lineage = dep.meta["tuning_lineage"]
    print(f"deployment for {dep.device} -> {args.out} ({time.perf_counter() - t0:.1f}s)")
    fractions = {"matmul": (result.oracle_fraction, result.classifier_fraction)} | {
        name: (r.oracle_fraction, r.classifier_fraction) for name, r in result.family_results.items()}
    for fname in ["matmul", *result.family_results]:
        configs, _tree = dep.family_tuning(fname)
        n_problems, n_configs = dep.meta["tables"][fname]
        oracle, clf = fractions[fname]
        print(f"  {fname:9s} table {n_problems} problems x {n_configs} configs, measured in "
              f"{lineage[fname]['measure_seconds']:.1f}s; deployed {[c.name() for c in configs]}; "
              f"oracle {oracle:.1%} / classifier {clf:.1%}")
    print("--- generated launcher (first lines) ---")
    print("\n".join(tree_to_python(dep.classifier).splitlines()[:8]))
    return result


if __name__ == "__main__":
    main()
