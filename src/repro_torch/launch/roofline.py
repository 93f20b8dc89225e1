"""Roofline analysis over the dry run's records, ported from
``repro/launch/roofline.py``, with an H100's constants in place of the TPU's.

Three terms per (arch x shape) cell from the records in ``build/dryrun/``:

  compute term    = FLOPs per device / peak FLOP/s
  memory term     = bytes accessed per device / HBM bandwidth
  collective term = collective bytes per device / link bandwidth

Semantics notes:
  * the records are per device (rank 0's local shards), reckoned on meta
    tensors (``launch/dryrun.py``): nothing here was measured;
  * as the reference does, the analytic MODEL_FLOPS (6·N_active·D train,
    2·N_active·D inference) per device picks the dominant term, and the
    MODEL/HLO column compares it with the recorded FLOPs (which count the
    remat recompute and any computation replicated over the ``model`` axis);
  * the port's ``bytes_accessed`` counts every op's operands and results
    once (no fusion), so the memory term is an upper bound on what a fused
    program would move;
  * collective bytes are the result bytes per device of every collective;
    the production mesh's 16-wide axes span two 8-card nodes, so one card's
    inter-node link is assumed (the conservative bound; within a node
    NVLink gives 450 GB/s a direction).

Constants (NVIDIA H100 SXM5 80GB, 700 W; NVIDIA H100 Tensor Core GPU data
sheet): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3.  Link: one ConnectX-7
NDR InfiniBand port a card, 400 Gb/s = 50 GB/s a direction (NVIDIA DGX H100
data sheet: eight 400 Gb/s ports, one per card).

Usage:  python -m repro_torch.launch.roofline [--dir build/dryrun --mesh single]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import registry

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per H100 SXM5 (700 W)
HBM_BW = 3.35e12  # bytes/s per H100 SXM5 80GB
LINK_BW = 50e9  # bytes/s per card across nodes: one 400 Gb/s NDR port


def model_flops(arch: str, shape: str) -> float:
    """Analytic useful FLOPs for one step of this cell (whole job)."""
    cfg = registry.get(arch)
    sp = registry.SHAPES[shape]
    n = cfg.n_active_params()
    b, s = sp.global_batch, sp.seq_len
    if sp.kind == "train":
        return 6.0 * n * b * s
    if sp.kind == "prefill":
        return 2.0 * n * b * s
    return 2.0 * n * b  # decode: one new token per sequence


def analyze_record(rec: dict) -> dict:
    arch, shape = rec["arch"], rec["shape"]
    chips = rec["devices"]
    mf = model_flops(arch, shape)
    flops = rec["flops"]  # per device
    coll = sum(v for k, v in rec["collectives"].items() if k.endswith("_bytes"))
    t_compute_rec = flops / PEAK_FLOPS
    t_compute = mf / chips / PEAK_FLOPS
    t_memory = rec["bytes_accessed"] / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    # Roofline fraction = intrinsic bound / achieved bound: the intrinsic bound of a step is
    # max(compute, memory); collectives are overhead against it.
    intrinsic = max(t_compute, t_memory)
    frac = intrinsic / step_time if step_time > 0 else 0.0
    compute_frac = t_compute / step_time if step_time > 0 else 0.0
    hints = {
        "compute": "compute-bound: at roofline for the mesh; only a faster-math kernel or more cards moves it",
        "memory": "memory-bound: cut HBM traffic (remat policy, bf16 state, fused kernels, shard the dominant "
                  "resident tensor further)",
        "collective": "collective-bound: reshard to shrink the largest collective or overlap it with compute",
    }
    return {
        "arch": arch,
        "shape": shape,
        "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_compute,
        "t_compute_recorded_s": t_compute_rec,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": frac,
        "compute_fraction": compute_frac,
        "model_flops": mf,
        "model_over_recorded": (mf / chips) / flops if flops else float("nan"),
        "bytes_per_device_gib": (rec["argument_bytes"] + rec["temp_bytes"]) / 2**30,
        "hint": hints[dominant],
    }


def load_records(dir_: Path, mesh: str, opts: str = "") -> list[dict]:
    """The dry run's records of ``mesh``: without options, or under ``opts`` ("a+b", as the
    dry run names its records ``<arch>__<shape>__<mesh>@<opts>.json``)."""
    suffix = f"@{opts}" if opts else ""
    return [json.loads(p.read_text()) for p in sorted(dir_.glob(f"*__{mesh}{suffix}.json"))]


def table(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "roofline frac | MODEL/recorded | GiB/dev |\n|---|---|---|---|---|---|---|---|---|"
    )
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | {r['dominant']} | "
            f"{r['roofline_fraction']:.2f} | {r['model_over_recorded']:.2f} | "
            f"{r['bytes_per_device_gib']:.1f} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--opt", default="", help="the records of a dry-run option, e.g. moe_cap_data")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = [analyze_record(r) for r in load_records(Path(args.dir), args.mesh, args.opt)]
    rows.sort(key=lambda r: r["roofline_fraction"])
    print(table(rows))
    worst = [r for r in rows if r["roofline_fraction"] < 0.5]
    print(f"\n{len(rows)} cells; {len(worst)} below 50% of roofline (reckoned, not measured)")
    for r in rows[:3]:
        print(f"  worst: {r['arch']} x {r['shape']} ({r['roofline_fraction']:.2f}) — {r['hint']}")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
