#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU and the CUDA toolkit; exits non-zero without them.
Phases (each one fails the run if its check fails):

1. card: the GPU's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel against plain: every compiled matmul config, in bf16->bf16,
   bf16->f32 and f32->f32, at ragged shapes and at every GEMM shape that
   full-width granite-8b serving gives the kernel, against ``matmul_plain``
   (TF32 off).  Error = max|kernel - plain| / max|plain|; limits 1e-2 (bf16
   out), 1e-3 (f32 out from bf16), 1e-5 (f32 in);
4. full-width serving: granite-8b unreduced (d_model 4096, 32 heads, 8 KV
   heads, d_ff 14336, vocab 49152, 36 layers), bf16, random weights from a
   CUDA generator, ServingEngine(max_batch=4, cache_len=256), 4 requests of
   8-100 tokens, 16 new tokens each.  Every forward (prefill or decode step)
   must launch the GEMM kernel exactly 7 * n_layers + 1 times;
5. selection reaches the kernel: one request under a FixedPolicy with a
   non-default config launches that config and not the default;
5b. profile: device time by kernel and the device's idle share over two
   full-width decode steps (torch.profiler);
6. CPU against card: the serving CLI on reduced granite-8b in f32, once with
   ``--device cuda`` and once with ``--device cpu``, same seed: equal greedy
   token streams;
7. GEMM timing: each served GEMM shape with CUDA events (median of 20 after
   warm-up, weights rotated through more than the 50 MB L2), beside its bound
   max(FLOPs / 989e12, bytes / 3.35e12), the plain version and torch.matmul
   (a yardstick only: the port never calls it);
8. the ``kernels`` JSON line, then the card line, then the result line.

Everything measured also goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
TOL = {("bf16", "bf16"): 1e-2, ("bf16", "f32"): 1e-3, ("f32", "f32"): 1e-5}
GRANITE_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 49152)]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_kernel_vs_plain(torch, mm) -> dict:
    """Every compiled config against the plain version, all three type pairs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    shapes = [(m, k, n) for m in (1, 4, 37, 128) for k in (100, 4100) for n in (96, 1024)]
    shapes += [(m, k, n) for m in (1, 4, 32, 64, 128) for k, n in GRANITE_KN]
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {pair: {"rel": 0.0, "abs": 0.0} for pair in TOL}
    checks = 0
    for m, k, n in shapes:
        a32 = torch.randn(m, k, device="cuda", generator=g)
        b32 = torch.randn(k, n, device="cuda", generator=g)
        for (src, dst), tol in TOL.items():
            a, b = a32.to(dt[src]), b32.to(dt[src])
            want = mm.matmul_plain(a, b, dt[dst]).float()
            scale = want.abs().max().item()
            for cfg in mm.config_space():
                got = mm.matmul_cuda(a, b, cfg, out_dtype=dt[dst]).float()
                err = (got - want).abs().max().item()
                require(err / scale <= tol, f"{cfg.name()} {src}->{dst} at {(m, k, n)}: "
                                            f"rel err {err / scale:.3g} > {tol}")
                w = worst[(src, dst)]
                w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                checks += 1
    torch.cuda.synchronize()
    for (src, dst), w in worst.items():
        print(f"  {src}->{dst}: worst rel err {w['rel']:.3g} (limit {TOL[(src, dst)]}), "
              f"worst abs err {w['abs']:.3g}")
    print(f"  {checks} checks over {len(shapes)} shapes x {len(mm.config_space())} configs: all within tolerance")
    return {f"{s}->{d}": w for (s, d), w in worst.items()} | {"checks": checks}


def phase_serve(torch, mm) -> dict:
    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = registry.get("granite-8b")
    require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (4096, 32, 8, 14336, 49152),
            f"unexpected granite-8b config {cfg}")
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  granite-8b full width: {cfg.n_layers} layers (no depth cut), d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16; weights {weight_bytes / 1e9:.2f} GB, "
          f"init {init_s:.1f}s")

    # A direct prefill: finite f32 logits over the padded vocab (also warms up).
    tokens = torch.randint(0, cfg.vocab, (1, 32), device="cuda")
    logits, _ = model.prefill(params, {"tokens": tokens}, 256)
    require(tuple(logits.shape) == (1, 1, cfg.padded_vocab()) and logits.dtype == torch.float32,
            f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    per_forward = 7 * cfg.n_layers + 1
    events: list[tuple[str, int, float]] = []  # (kind, kernel launches, seconds)
    mark = {"launches": 0, "t": 0.0}

    def record(kind):
        def hook(_size):
            torch.cuda.synchronize()
            now, total = time.perf_counter(), mm.total_launches()
            events.append((kind, total - mark["launches"], now - mark["t"]))
            mark["launches"], mark["t"] = total, now
        return hook

    rt = KernelRuntime(name="chip_smoke")
    rt.install(FixedPolicy())
    rt.set_selection_logging(True, cap=1 << 16)
    engine = ServingEngine(model, params, max_batch=4, cache_len=256, runtime=rt,
                           on_prefill=record("prefill"), on_decode=record("decode"))
    rng = torch.Generator().manual_seed(2)
    lengths = (8, 37, 64, 100)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in lengths]

    # The main path: counts to 0 just before, read just after.
    torch.cuda.synchronize()
    mm.reset_launches()
    mark["t"] = t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
    status = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mm.LAUNCHES)

    require(status.completed == 4 and not status.exhausted, f"not every request completed: {status}")
    require(all(len(t.request.output) == 16 for t in tickets), "a request got fewer than 16 tokens")
    bad = [(kind, n) for kind, n, _ in events if n != per_forward]
    require(not bad, f"forwards with a GEMM launch count other than {per_forward}: {bad}")
    require(sum(launches.values()) == per_forward * len(events), "launches outside the forwards")
    stats = rt.shape_cache_stats()
    require(stats["hits"] + stats["misses"] == sum(launches.values()) and stats["hits"] > 0,
            f"selection shape cache not consulted on every GEMM: {stats}")
    n_prefill = sum(1 for e in events if e[0] == "prefill")
    n_decode = len(events) - n_prefill
    # Launches per decode step, per (k, n), read from the selection log.
    counts: dict[str, int] = {}
    for op, (m, k, n, batch), _cfg in rt.selection_log():
        if m == 1 and batch == 4:  # decode GEMMs: (B=4, 1, D) activations
            counts[f"{k}x{n}"] = counts.get(f"{k}x{n}", 0) + 1
    per_step = {kn: c / n_decode for kn, c in counts.items()}
    toks = sum(len(t.request.output) for t in tickets)
    prefill_ms = [round(s * 1e3, 3) for kind, _, s in events if kind == "prefill"]
    decode_ms = [s * 1e3 for kind, _, s in events if kind == "decode"]
    print(f"  served 4 requests (prompts {lengths}) x 16 tokens: {toks} tokens in {wall:.3f}s "
          f"({toks / wall:.1f} tok/s); {n_prefill} prefills, {n_decode} decode steps")
    print(f"  prefill ms {prefill_ms}; decode step ms median {statistics.median(decode_ms):.3f} "
          f"(min {min(decode_ms):.3f}, max {max(decode_ms):.3f})")
    print(f"  GEMM launches: {per_forward} per forward (7 x {cfg.n_layers} + 1) on every one of "
          f"{len(events)} forwards; shape cache {stats['hits']} hits / {stats['misses']} misses")
    print(f"  decode-step launches per (k x n): {per_step}")
    return {
        "n_layers": cfg.n_layers, "weight_bytes": weight_bytes, "tokens": toks, "wall_s": wall,
        "tok_per_s": toks / wall, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "launches": launches, "per_forward": per_forward, "forwards": len(events),
        "per_decode_step": per_step, "shape_cache": {k: stats[k] for k in ("hits", "misses")},
        "engine": engine, "model": model, "params": params, "prompts": prompts,
    }


def phase_policy(mm, serve: dict) -> dict:
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    other = mm.MatmulConfig(16, 128, 64, "nmk")
    require(other in mm.config_space() and other != mm.DEFAULT_CONFIG, "bad choice of config")
    rt = KernelRuntime(name="chip_smoke-fixed")
    rt.install(FixedPolicy(matmul_config=other))
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt)
    mm.reset_launches()
    engine.submit(serve["prompts"][0], max_new_tokens=4)
    engine.drain()
    got, default = mm.LAUNCHES[other.name()], mm.LAUNCHES[mm.DEFAULT_CONFIG.name()]
    require(got == 4 * serve["per_forward"] and default == 0,
            f"FixedPolicy({other.name()}) launched it {got} times, the default {default} times")
    print(f"  FixedPolicy({other.name()}): {got} launches of it, {default} of the default")
    return {"config": other.name(), "launches": got, "default_launches": default}


def phase_cpu_vs_card() -> dict:
    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", "granite-8b", "--reduced", "--requests", "4", "--max-new-tokens", "8"]
    card = serve_cli.main(argv + ["--device", "cuda"])
    cpu = serve_cli.main(argv + ["--device", "cpu"])
    if card != cpu:
        _report_divergence(card, cpu, argv)
    require(card == cpu, "greedy token streams differ between cuda and cpu")
    print(f"  reduced granite-8b f32: cuda and cpu token streams equal ({sum(map(len, cpu))} tokens)")
    return {"equal": True, "tokens": sum(map(len, cpu))}


def _report_divergence(card, cpu, argv) -> None:
    """Top-2 logit gap at the first token where the streams part."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    i = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
    j = next(j for j, (a, b) in enumerate(zip(card[i], cpu[i])) if a != b)
    cfg = registry.get("granite-8b").reduced()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(len(card), 8))[i]
    seq = torch.as_tensor(np.concatenate([prompt, cpu[i][:j]]))[None]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        logits, _ = model.prefill(params, {"tokens": seq.to(dev)}, 128)
        top = torch.topk(logits[0, -1].float().cpu(), 2)
        print(f"  divergence at request {i} token {j}: {dev} top-2 {top.indices.tolist()} "
              f"gap {(top.values[0] - top.values[1]).item():.3g}")


def phase_profile(torch, serve: dict) -> dict:
    """Device time by kernel over two full-width decode steps (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = serve["engine"]
    for p in serve["prompts"]:
        engine.submit(p, max_new_tokens=4)
    engine.step()  # prefills + the first decode step, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.drain()
    by_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = "matmul (gemm_*_kernel)" if "gemm_" in evt.key else evt.key[:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    if busy == 0:
        print("  the profiler recorded no device time: device busy share not measured")
        return {"wall_ms": wall_ms, "busy_ms": None}
    print(f"  2 decode steps (batch 4): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall_ms:.3f}")
    for name, ms in top:
        print(f"    {ms:9.3f} ms  {name}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms, "top": top}


def _time_ms(torch, fn, n_warm=3, n_runs=20) -> float:
    for i in range(n_warm):
        fn(i)
    times = []
    for i in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(torch, mm, per_step: dict) -> list[dict]:
    rows = []
    g = torch.Generator(device="cuda").manual_seed(3)
    for m in (4, 128):
        for k, n in GRANITE_KN:
            out_dtype = torch.float32 if n == 49152 else torch.bfloat16  # the vocab GEMM emits f32 logits
            a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            b_bytes = k * n * 2
            copies = max(1, -(-150_000_000 // b_bytes))  # rotate weights through > 3x the L2
            bs = [torch.randn(k, n, device="cuda", generator=g).bfloat16() for _ in range(copies)]
            out_bytes = m * n * (4 if out_dtype == torch.float32 else 2)
            flops = 2 * m * k * n
            nbytes = m * k * 2 + b_bytes + out_bytes
            bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            per_cfg = {
                cfg.name(): _time_ms(torch, lambda i, c=cfg: mm.matmul_cuda(a, bs[i % copies], c, out_dtype=out_dtype))
                for cfg in mm.config_space()
            }
            plain = _time_ms(torch, lambda i: mm.matmul_plain(a, bs[i % copies], out_dtype))
            library = _time_ms(torch, lambda i: torch.matmul(a, bs[i % copies]).to(out_dtype))
            best = min(per_cfg, key=per_cfg.get)
            row = {
                "m": m, "k": k, "n": n, "out": str(out_dtype).replace("torch.", ""),
                "ms": per_cfg[mm.DEFAULT_CONFIG.name()], "best_config": best, "best_ms": per_cfg[best],
                "plain_ms": plain, "library_ms": library, "bound_ms": bound,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                "launches_per_decode_step": per_step.get(f"{k}x{n}", 0) if m == 4 else None,
                "per_config_ms": per_cfg,
            }
            rows.append(row)
            print(f"  m={m:<4} k={k:<6} n={n:<6} {row['out']:>8}: kernel {row['ms']:.4f} ms "
                  f"(best {best} {per_cfg[best]:.4f}), bound {bound:.4f} ms ({row['bound_by']}), "
                  f"plain {plain:.4f}, torch.matmul {library:.4f}"
                  + (f", {row['launches_per_decode_step']:g} launches/decode step" if m == 4 else ""))
            del bs
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mm

    t_start = time.perf_counter()
    print("[1] card")
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    print("[2] build")
    t0 = time.perf_counter()
    tiles = mm.compiled_tiles()
    print(f"  matmul.cu -> sm_90a in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {_build.build_seconds.get('matmul', 0.0):.1f}s); tiles (bm, bn, bk, smem bf16, smem f32): {tiles}")
    regs = [line.split(":", 1)[1].strip() for line in _build.build_log("matmul").splitlines()
            if "registers" in line]
    print(f"  ptxas: {len(regs)} kernels; {sorted(set(regs))}")

    print("[3] kernel against plain")
    errors = phase_kernel_vs_plain(torch, mm)

    print("[4] full-width serving")
    serve = phase_serve(torch, mm)

    print("[5] selection reaches the kernel")
    policy = phase_policy(mm, serve)
    print("[5b] where a decode step's time goes")
    profile = phase_profile(torch, serve)
    for key in ("engine", "model", "params", "prompts"):
        serve.pop(key)
    torch.cuda.empty_cache()

    print("[6] cpu against card")
    parity = phase_cpu_vs_card()

    print("[7] GEMM timing (bf16, DEFAULT_CONFIG = the config served)")
    rows = phase_timing(torch, mm, serve["per_decode_step"])

    # One decode step's GEMMs at m=4: sum of count x time over the shapes it launches.
    step = [r for r in rows if r["m"] == 4]
    total = lambda key: sum(r[key] * r["launches_per_decode_step"] for r in step)
    kernels = {"kernels": [{
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:120",
        "launches": sum(serve["launches"].values()),
        "max_abs_err": max(w["abs"] for k, w in errors.items() if k != "checks"),
        "max_rel_err": max(w["rel"] for k, w in errors.items() if k != "checks"),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes",
        "library_ms": total("library_ms"),
        "timed_as": "all GEMMs of one granite-8b decode step (batch 4), summed over shapes",
    }]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "errors": {k: v for k, v in errors.items()}, "serve": serve, "policy": policy, "profile": profile,
        "cpu_vs_card": parity, "timing": rows, "kernels": kernels["kernels"],
        "seconds": time.perf_counter() - t_start,
    }, indent=1, default=str))
    print(f"[8] done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
