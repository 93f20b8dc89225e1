#!/usr/bin/env python3
"""Time the port's WKV backward from two source trees in turns on one card.

    python3 scripts/wkv_ab.py --bwd --base build/parent --out build/wkv_ab_bwd.json

``--base`` is another checkout of the repository (for example ``git archive``
of a parent commit unpacked under ``build/``); the other tree is this one.
Each turn is a fresh process that builds and loads ``csrc/wkv_bwd.cu`` (and
``csrc/wkv.cu``, whose forward makes the chunk start states the backward
reads) from its tree and times ``wkv_backward_cuda`` with
``core/gpubench.time_ms`` (CUDA events, each call queued behind a device
sleep) on the same inputs drawn from one seed, given the forward's states as
the training step gives them, no initial state and no final-state cotangent:
rwkv6-7b's training shape (8, 128, 64, 64) in f32 and bf16 under
``DEFAULT_WKV_CONFIG`` (chunk 16), the same shape in f32 at every other
compiled chunk, and the long (1, 2048, 64, 64) f32 call at chunk 16.  The
turns run base, this tree, this tree, base, so that drift on the card falls
on both alike; each tree's number is the mean of its two turns.  Beside each
row: the shape's bytes bound and, where the tree has ``wkv.bwd_residency``,
the walk's registers, spilled bytes, CTAs an SM, grid, waves and segments.
``chip_smoke.py`` calls :func:`run_bwd_turns` in phase 25f-i when
``build/parent`` exists.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory rate
# (B, S, H, hd), r/k/v dtype, chunk: the training shape in both dtypes at the default chunk, then
# f32 at every other compiled chunk, then the long call.
BWD_ROWS = (((8, 128, 64, 64), "float32", 16), ((8, 128, 64, 64), "bfloat16", 16),
            ((8, 128, 64, 64), "float32", 8), ((8, 128, 64, 64), "float32", 32),
            ((8, 128, 64, 64), "float32", 64), ((8, 128, 64, 64), "float32", 128),
            ((1, 2048, 64, 64), "float32", 16))


def bwd_bytes(b: int, s: int, h: int, hd: int, size: int) -> int:
    """Bytes the backward must move, each input read once and each output written once (no
    initial state): r, k, v in and dr, dk, dv out in r's type, logw, do in and dlogw out in
    f32, u in and du out."""
    n = b * s * h * hd
    return 6 * n * size + 3 * n * 4 + 2 * h * hd * size


def worker_bwd(src: Path) -> dict:
    """Times the backward at BWD_ROWS with the kernels of the tree whose package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import wkv as wk

    if not torch.cuda.is_available():
        raise RuntimeError("wkv_ab times on the card and torch finds no CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (b, s, h, hd), dtype_name, chunk in BWD_ROWS:
        dtype = getattr(torch, dtype_name)
        cfg = wk.WkvConfig(chunk)
        g = torch.Generator(device="cuda").manual_seed(32 + s + chunk)
        randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
        r, k, v = (randn(b, s, h, hd) * 0.5).to(dtype), (randn(b, s, h, hd) * 0.5).to(dtype), randn(b, s, h, hd).to(dtype)
        logw = -torch.exp(randn(b, s, h, hd) * 0.5).clamp(1e-3, 5.0)
        u = (randn(h, hd) * 0.3).to(dtype)
        do = randn(b, s, h, hd)
        _, s_fin, hs = wk.wkv_cuda(r, k, v, logw, u, None, config=cfg, keep_states=True)
        call = lambda i: wk.wkv_backward_cuda(r, k, v, logw, u, None, do, None, cfg, (hs, s_fin))
        size = 2 if dtype == torch.bfloat16 else 4
        row = {"shape": [b, s, h, hd], "dtype": dtype_name, "config": cfg.name(),
               "ms": time_ms(call, n_warm=3, n_runs=20),
               "bound_ms": bwd_bytes(b, s, h, hd, size) / HBM_BYTES_PER_S * 1e3}
        if hasattr(wk, "bwd_residency"):
            res = wk.bwd_residency(wk.WkvConfig(wk.launch_chunk(cfg, s)), hd, 0, dtype == torch.bfloat16,
                                   u.dtype == torch.float32)
            n = -(-s // wk.launch_chunk(cfg, s))
            seg_len = wk.bwd_segment_len(b * h, n, sms, res["ctas"])
            grid = b * h * -(-n // seg_len)
            row.update(res, grid=grid, threads=256, waves=grid / (sms * res["ctas"]), segments=-(-n // seg_len),
                       smem_bytes=wk.WkvConfig(wk.launch_chunk(cfg, s)).bwd_smem_bytes(hd))
        rows.append(row)
        del call, r, k, v, logw, u, do, hs, s_fin
        torch.cuda.empty_cache()
    return {"src": str(src), "rows": rows}


def _turn(src: Path, timeout: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "turn.json"
        subprocess.run([sys.executable, __file__, "--worker", str(src), "--out", str(out), "--bwd"], check=True,
                       timeout=timeout)
        return json.loads(out.read_text())


def run_bwd_turns(base: Path, timeout: float = 600.0) -> dict:
    """The backward's turns (base, this tree, this tree, base); each tree's time a row, the mean
    of its two turns, beside this tree's residency."""
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], timeout))
    merged = {}
    for name, (t1, t2) in turns.items():
        merged[name] = [r1 | {"ms": (r1["ms"] + r2["ms"]) / 2, "turn_ms": [r1["ms"], r2["ms"]]}
                        for r1, r2 in zip(t1["rows"], t2["rows"])]
    return {"order": ["base", "this", "this", "base"], "base": str(base), "mode": "bwd", "trees": merged}


def report_bwd(result: dict) -> None:
    for b, t in zip(result["trees"]["base"], result["trees"]["this"]):
        res = (f"; {t['registers']} registers, {t['local_bytes']} spilled bytes a thread, {t['threads']} threads, "
               f"{t['smem_bytes']} bytes of shared memory, {t['ctas']} CTAs an SM, grid {t['grid']} = "
               f"{t['waves']:.2f} waves, {t['segments']} segment(s)") if "ctas" in t else ""
        print(f"  backward {tuple(t['shape'])} {t['dtype']}, {t['config']}: {b['ms']:.4f} -> {t['ms']:.4f} ms "
              f"({b['ms'] / t['ms']:.2f}x; bound {t['bound_ms']:.4f} ms, bytes){res}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--out", type=Path, help="default build/wkv_ab_bwd.json")
    ap.add_argument("--bwd", action="store_true", required=True,
                    help="time the backward kernel (module docstring); the only mode")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        args.out.write_text(json.dumps(worker_bwd(args.worker)))
        return 0
    if not (args.base / "src" / "repro_torch" / "kernels" / "csrc" / "wkv_bwd.cu").is_file():
        print(f"wkv_ab: {args.base} holds no src/repro_torch/kernels/csrc/wkv_bwd.cu", file=sys.stderr)
        return 2
    result = run_bwd_turns(args.base)
    out = args.out or ROOT / "build" / "wkv_ab_bwd.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    report_bwd(result)
    print(f"  -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
