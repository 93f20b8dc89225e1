#!/usr/bin/env python3
"""Readings behind chip_smoke.py phase 17c's logits limit, over several draws of weights.

    python3 scripts/logit_gate_draws.py [--seeds 8] [--depth 8] [--out chiprun_out/logit_gate_draws.json]

Phase 17c holds the prefill logits of rwkv6-7b and hymba-1.5b (full width, f32,
the model's first ``depth`` layers) served under the bundle's WKV / scan
configs against ``FixedPolicy()``'s.  Two configs of one kernel sum in other
orders, and a random-weight model amplifies that rounding, so the two logits
differ by an amount that depends on the draw.  This script builds each model
as 17c does (the full-depth random init from a CUDA generator of seed s, cut to
the first ``depth`` layers), prefills phase 4's four prompts left-padded to the
engine's buckets, eagerly, and records ``max|a - b| / max|b|`` of the last
position's logits against ``FixedPolicy()``'s:

  * sound: every compiled config of the model's sequence kernel (``wkv`` or
    ``ssm_scan``), which computes the same function in another order;
  * fault controls: the default config fed its f32 operands rounded to TF32
    (10 mantissa bits) and to bf16 (7 bits), what a kernel that loads its f32
    inputs at a lower precision would give.

It prints one JSON line per (arch, seed) and a summary line: the largest
sound reading and the smallest reading of each control.  17c's limit must sit
between them.  Needs the card (~3 min).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("rwkv6-7b", "hymba-1.5b")
PROMPT_LENGTHS = (8, 37, 64, 100)  # chip_smoke.py phase 4's requests
CACHE_LEN = 256


def round_tf32(torch, t):
    """``t`` (f32) rounded to 10 mantissa bits, to nearest (ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & -(1 << 13)).view(torch.float32)


def round_bf16(torch, t):
    return t.bfloat16().float()


def with_rounded_inputs(torch, fn, rnd):
    """``fn`` with every f32 tensor argument rounded by ``rnd`` first."""
    def run(*args):
        return fn(*(rnd(torch, a) if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a
                    for a in args))
    return run


def first_layers(tree, n: int):
    """The stacked per-layer weights of a params subtree, cut to the first ``n`` layers."""
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "logit_gate_draws.json")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import _bucket, _extend_ladder

    if not torch.cuda.is_available():
        print("logit_gate_draws: torch finds no CUDA device; the readings are taken only on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    _build.load_all(["matmul", "wkv", "ssm"])
    ladder = _extend_ladder((32, 64, 128), CACHE_LEN)
    gen = torch.Generator().manual_seed(2)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    rows = []
    for arch in ARCHS:
        cfg = registry.get(arch)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).numpy() for n in PROMPT_LENGTHS]
        batches = []
        for p in prompts:
            tokens = np.zeros((1, _bucket(len(p), ladder)), dtype=np.int64)
            tokens[0, tokens.shape[1] - len(p):] = p
            batches.append({"tokens": torch.from_numpy(tokens).cuda()})
        if cfg.family == "ssm":
            field, space, entry = "wkv_config", wk.config_space(), "wkv_cuda"
        else:
            field, space, entry = "ssm_config", ss.config_space(), "ssm_cuda_fused"
        default = getattr(ops.FixedPolicy(), field)
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        shallow = build_model(dataclasses.replace(cfg, n_layers=args.depth), dtype=torch.float32,
                              param_dtype=torch.float32, device="cuda")
        for seed in range(args.seeds):
            params = model.init(torch.Generator(device="cuda").manual_seed(seed))
            cut = dict(params, blocks=first_layers(params["blocks"], args.depth))

            def logits(policy_cfg):
                rt = KernelRuntime(name=f"logit_gate_draws[{arch}]")
                rt.install(ops.FixedPolicy(**{field: policy_cfg}))
                with rt.activate():
                    out = [shallow.prefill(cut, b, CACHE_LEN)[0].float() for b in batches]
                if not all(bool(torch.isfinite(o).all()) for o in out):
                    raise SystemExit(f"{arch} seed {seed} {policy_cfg.name()}: non-finite logits")
                return out

            base = logits(default)
            sound = {c.name(): [rel(a, b) for a, b in zip(logits(c), base)] for c in space if c != default}
            controls = {}
            orig = getattr(ops, entry)
            for name, rnd in (("tf32_inputs", round_tf32), ("bf16_inputs", round_bf16)):
                setattr(ops, entry, with_rounded_inputs(torch, orig, rnd))
                try:
                    controls[name] = [rel(a, b) for a, b in zip(logits(default), base)]
                finally:
                    setattr(ops, entry, orig)
            row = {"arch": arch, "seed": seed, "depth": args.depth, "default": default.name(),
                   "buckets": [b["tokens"].shape[1] for b in batches], "sound": sound, "controls": controls,
                   "sound_max": max(max(v) for v in sound.values()),
                   "control_min": {k: min(v) for k, v in controls.items()}}
            rows.append(row)
            print(json.dumps(row))
            del params, cut, base
            gc.collect()
            torch.cuda.empty_cache()
        del model, shallow
    summary = {"card": card, "seeds": args.seeds, "depth": args.depth,
               "sound_max": max(r["sound_max"] for r in rows),
               "control_min": {k: min(r["control_min"][k] for r in rows) for k in rows[0]["control_min"]},
               "by_arch": {a: {"sound_max": max(r["sound_max"] for r in rows if r["arch"] == a),
                               "control_min": {k: min(r["control_min"][k] for r in rows if r["arch"] == a)
                                               for k in rows[0]["control_min"]}} for a in ARCHS}}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"summary": summary, "rows": rows}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
