#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU and the CUDA toolkit; exits non-zero without them.
Phases (each one fails the run if its check fails):

1. card: the GPU's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (matmul, wkv, ssm, attention), one nvcc per source, all started together;
3. GEMM against plain: every compiled matmul config, in bf16->bf16,
   bf16->f32 and f32->f32, at ragged shapes and at every GEMM shape that
   full-width granite-8b, rwkv6-7b and hymba-1.5b serving give the kernel, against
   ``matmul_plain`` (TF32 off).  Error = max|kernel - plain| / max|plain|;
   limits 1e-2 (bf16 out), 1e-3 (f32 out from bf16), 1e-5 (f32 in);
3b. WKV against plain: every compiled chunk config, r/k/v in bf16 and f32,
   head dims 16 and 64, S in {1, 7, 16, 50, 128, 300} (and the served
   (1, S, 64, 64) at S in {32, 64, 128}), with and without an initial state,
   nonzero u, decays drawn as the reference test draws them, at the clamp
   (-5) and a -5 / -1e-3 mix, against ``wkv_plain`` (TF32 off).  Limit
   1e-4 relative to max|plain| for the output and the final state; every
   output finite;
4. full-width granite-8b serving: unreduced (d_model 4096, 32 heads, 8 KV
   heads, d_ff 14336, vocab 49152, 36 layers), bf16, random weights from a
   CUDA generator, ServingEngine(max_batch=4, cache_len=256), 4 requests of
   8-100 tokens, 16 new tokens each.  Every forward (prefill or decode step)
   must launch the GEMM kernel exactly 7 * n_layers + 1 times;
5. selection reaches the kernel: one request under a FixedPolicy with a
   non-default matmul config launches that config and not the default;
5b. profile: device time by kernel and the device's idle share over two
   full-width granite decode steps (torch.profiler);
6. CPU against card: the serving CLI on reduced granite-8b in f32, once with
   ``--device cuda`` and once with ``--device cpu``, same seed: equal greedy
   token streams;
7. GEMM timing: each served granite GEMM shape with CUDA events (median of 20
   after warm-up, each call queued behind a device sleep so that the events
   hold device time, weights rotated through more than the 50 MB L2), beside
   its bound max(FLOPs / 989e12, bytes / 3.35e12), one call from an idle
   device (host launch work included), the plain version and torch.matmul (a
   yardstick only: the port never calls it);
8. full-width rwkv6-7b serving, after granite's weights are released:
   unreduced (32 layers, d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab
   65536), bf16, the same engine and requests.  Every forward launches the
   GEMM 10 * n_layers + 1 times; every prefill launches the WKV kernel
   n_layers times and every decode step 0 times;
9. selection reaches the WKV kernel: one request under
   FixedPolicy(wkv_config=WkvConfig(64)) launches wkv_c64 and not wkv_c16;
9b. profile: one rwkv6-7b prefill and two decode steps (torch.profiler);
10. CPU against card: the serving CLI on reduced rwkv6-7b in f32, cuda and
   cpu: equal greedy token streams;
11. timing: the WKV kernel at (1, S, 64, 64), S in {32, 64, 128}, every
   chunk config, beside its bound max(bytes / 3.35e12, 5 hd^2 f32 operations
   per token and head / 67e12) and the plain version; the GEMM at rwkv6-7b's
   decode shapes as in phase 7;
3c. (run with phase 3) SSM against plain: every compiled (block_d, chunk)
   config, state sizes 8 and 16, with and without an initial state, S in
   {1, 7, 50, 128, 300} at a ragged d = 100, and the served (1, S, 1600, 16)
   at S in {32, 64, 128}, dta drawn as the reference test draws it
   (-exp(0.3 normal)), against ``ssm_plain``.  Limit 1e-4 relative to
   max|plain| for y and the final state; every output finite;
12. full-width hymba-1.5b serving, after rwkv6-7b's weights are released:
   unreduced (32 layers, d_model 1600, 25 heads, 5 KV heads of 64, d_ff 5504,
   vocab 32001, ssm_state 16, window 2048), bf16, the same engine and
   requests.  Every forward launches the GEMM 13 * n_layers + 1 times; every
   prefill launches the SSM kernel n_layers times and every decode step 0
   times;
13. selection reaches the SSM kernel: one request under
   FixedPolicy(ssm_config=SsmConfig(8, 16)) launches ssm_bd8_c16 n_layers
   times and the default not at all;
13b. profile: one hymba-1.5b prefill and two decode steps (torch.profiler);
14. CPU against card on Hymba, in process: reduced hymba-1.5b at 4 layers
   (one sliding-window layer, window 32), f32, cache_len 128, prompts of 20
   and 45 tokens (buckets 32 and 64: the ring is written by the ring-buffer
   prefill and wraps in decode), 16 new tokens each: equal greedy token
   streams on cuda and cpu;
15. timing: the SSM kernel at (1, S, 1600, 16), S in {32, 64, 128}, every
   config, beside its bound max(bytes / 3.35e12, 6 f32 operations per (t,
   channel, state) / 67e12) and the plain version; the GEMM at hymba-1.5b's
   decode shapes as in phase 7;
16. attention against plain: every compiled (block_q, block_kv) config, q/k/v in
   bf16 and f32, head dims 64 and 128, causal and not, at (2, 3) heads for (sq,
   skv) in {(1, 1), (1, 300), (7, 7), (50, 130), (128, 128), (64, 1000)} and
   (40, 24) (sq > skv: the 16 rows that see nothing must be zeros), and at the
   served (1, 32, 1, 32768) and (1, 32, 4096, 4096), against
   ``attention_plain`` (TF32 off).  Limits relative to max|plain|: 1e-2 for a
   bf16 output, 1e-4 for f32; every output finite;
17. tune on the card: ``python -m repro_torch.launch.tune --archs
   granite-8b,hymba-1.5b --families attention --n-kernels 4 --out
   build/deploy_h100.json`` in process: the matmul table (93 problems x 10
   configs) and the attention table (11 problems x 9 configs) measured with the
   port's kernels, the paper's pipeline, the Deployment written; the table
   sizes, seconds, deployed configs and fractions recorded;
18. the quickstart's path: the Deployment loaded into a fresh KernelRuntime
   (selection logging on); under ``rt.activate()``, ``ops.attention`` at every
   harvested attention problem at (1, 32) heads in bf16, twice (the second a
   shape-cache hit), each call launching exactly the config
   ``Deployment.select_attention`` names and matching the plain version within
   1e-2; ``ops.matmul`` at the quickstart's two shapes launching the tree's
   matmul config.  Each problem's kernel, plain and SDPA times beside its bound;
19. full-width granite-8b served as in phase 4 under the tuned Deployment: 7 *
   n_layers + 1 GEMM launches per forward, the split over the deployed configs,
   tokens/s, the decode step, and one decode step's GEMM device time under the
   tree's choices (from phase 7's per-config times) beside the default config's
   and each shape's best; whether the greedy streams equal phase 4's;
19b. profile: two decode steps of the tuned run (torch.profiler), as phase 5b;
20. attention timing: every config at granite-8b's (1, 32, S, 128) and
   hymba-1.5b's (1, 25, S, 64), causal S in {512, 2048, 4096} and a decode step
   at 4096 and 32768 cached tokens, beside the bound max(FLOPs / 989e12, bytes /
   3.35e12), one call from an idle device, the plain version and SDPA with
   ``causal_lower_right`` (a yardstick only: the port never calls it);
21. the ``kernels`` JSON line, then the card line, then the result line.

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
F32_FLOPS = 67e12  # outside the tensor cores
TOL = {("bf16", "bf16"): 1e-2, ("bf16", "f32"): 1e-3, ("f32", "f32"): 1e-5}
WKV_TOL = 1e-4  # both sides compute in f32 from the same values; the reference kernel test's tolerance
GRANITE_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 49152)]
RWKV_KN = [(4096, 4096), (4096, 64), (64, 4096), (4096, 14336), (14336, 4096), (4096, 65536)]
HYMBA_KN = [(1600, 1600), (1600, 320), (1600, 3200), (1600, 48), (48, 1600), (1600, 16), (1600, 5504),
            (5504, 1600), (1600, 32128)]
VOCAB_KN = {(4096, 49152), (4096, 65536), (1600, 32128)}
SSM_TOL = 1e-4  # both sides compute in f32 from the same values; the reference kernel test's rtol
PROMPT_LENGTHS = (8, 37, 64, 100)
# Attention against plain, relative to max |plain|: a bf16 output is one rounding (2^-8) from
# the f32 answer on each side; f32 sums in another order.
ATTN_TOL = {"bf16": 1e-2, "f32": 1e-4}
TUNED_ARCHS = ("granite-8b", "hymba-1.5b")
DEPLOY_PATH = ROOT / "build" / "deploy_h100.json"


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
    shapes += [(m, k, n) for m in (1, 4, 32, 64, 128) for k, n in dict.fromkeys(GRANITE_KN + RWKV_KN + HYMBA_KN)]
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


def _wkv_inputs(torch, g, b, s, h, hd, dtype, decay, with_state):
    """r/k/v/u in ``dtype``, logw and the state in f32, drawn as the reference's
    kernel test draws them; ``decay`` picks logw: 'dist', 'clamp' or 'mix'."""
    shape = (b, s, h, hd)
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    r, k, v = randn(*shape) * 0.5, randn(*shape) * 0.5, randn(*shape)
    logw = -torch.exp(randn(*shape) * 0.5).clamp(1e-3, 5.0)
    if decay == "clamp":
        logw = torch.full(shape, -5.0, device="cuda")
    elif decay == "mix":
        logw = torch.where(torch.rand(shape, device="cuda", generator=g) < 0.5, -5.0, -1e-3)
    u = randn(h, hd) * 0.3
    state = randn(b, h, hd, hd) * 0.1 if with_state else None
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u.to(dtype), state


def phase_wkv_vs_plain(torch, wk) -> dict:
    """Every compiled chunk config against the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = [(2, s, 3, hd) for hd in (16, 64) for s in (1, 7, 16, 50, 128, 300)]
    shapes += [(1, s, 64, 64) for s in (32, 64, 128)]  # what rwkv6-7b prefill gives the kernel
    worst = {"rel": 0.0, "abs": 0.0}
    clamp_finite = {c.name(): True for c in wk.config_space()}
    checks = 0
    for b, s, h, hd in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for decay in ("dist", "clamp", "mix"):
                for with_state in (True, False):
                    args = _wkv_inputs(torch, g, b, s, h, hd, dtype, decay, with_state)
                    want = wk.wkv_plain(*args)
                    scales = [w.abs().max().item() for w in want]
                    for cfg in wk.config_space():
                        got = wk.wkv_cuda(*args, config=cfg)
                        for name, x, w, scale in zip(("o", "state"), got, want, scales):
                            finite = bool(torch.isfinite(x).all())
                            require(finite, f"{cfg.name()} {name} not finite at {(b, s, h, hd)} {dtype} {decay}")
                            err = (x - w).abs().max().item()
                            require(err <= WKV_TOL * scale,
                                    f"{cfg.name()} {name} at {(b, s, h, hd)} {dtype} {decay} state={with_state}: "
                                    f"rel err {err / scale:.3g} > {WKV_TOL}")
                            worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
                            if decay != "dist":
                                clamp_finite[cfg.name()] &= finite
                        checks += 1
    torch.cuda.synchronize()
    print(f"  {checks} checks ({len(shapes)} shapes x 2 dtypes x 3 decays x 2 states x "
          f"{len(wk.config_space())} configs): worst rel err {worst['rel']:.3g} (limit {WKV_TOL}), "
          f"worst abs err {worst['abs']:.3g}; finite at logw = -5 and the -5 / -1e-3 mix: {clamp_finite}")
    return worst | {"checks": checks, "clamp_finite": clamp_finite}


def _ssm_inputs(torch, g, b, s, d, n, with_state):
    """dtx, dta, b, c (and the state) in f32, drawn as the reference's kernel
    test draws them (tests/test_ssm_kernel.py:_inputs)."""
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    dtx, dta = randn(b, s, d) * 0.5, -torch.exp(randn(b, s, d, n) * 0.3)
    bv, cv = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5
    return dtx, dta, bv, cv, (randn(b, d, n) * 0.1 if with_state else None)


def phase_ssm_vs_plain(torch, ss) -> dict:
    """Every compiled (block_d, chunk) config against the plain version."""
    g = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(2, s, 100, n) for n in (8, 16) for s in (1, 7, 50, 128, 300)]
    shapes += [(1, s, 1600, 16) for s in (32, 64, 128)]  # what hymba-1.5b prefill gives the kernel
    worst = {"rel": 0.0, "abs": 0.0}
    checks = 0
    for b, s, d, n in shapes:
        for with_state in (True, False):
            args = _ssm_inputs(torch, g, b, s, d, n, with_state)
            want = ss.ssm_plain(*args)
            scales = [w.abs().max().item() for w in want]
            for cfg in ss.config_space():
                got = ss.ssm_cuda(*args, config=cfg)
                for name, x, w, scale in zip(("y", "state"), got, want, scales):
                    require(bool(torch.isfinite(x).all()), f"{cfg.name()} {name} not finite at {(b, s, d, n)}")
                    err = (x - w).abs().max().item()
                    require(err <= SSM_TOL * scale, f"{cfg.name()} {name} at {(b, s, d, n)} state={with_state}: "
                                                    f"rel err {err / scale:.3g} > {SSM_TOL}")
                    worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
                checks += 1
    torch.cuda.synchronize()
    print(f"  {checks} checks ({len(shapes)} shapes x 2 states x {len(ss.config_space())} configs): worst rel err "
          f"{worst['rel']:.3g} (limit {SSM_TOL}), worst abs err {worst['abs']:.3g}; every output finite")
    return worst | {"checks": checks}


# Per arch: GEMM launches per forward, and launches per prefill of each
# sequence kernel (every decode step launches none of them).
def _expected(cfg) -> tuple[int, dict[str, int]]:
    n = cfg.n_layers
    if cfg.name == "granite-8b":
        require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (4096, 32, 8, 14336, 49152),
                f"unexpected granite-8b config {cfg}")
        return 7 * n + 1, {"wkv": 0, "ssm": 0}
    if cfg.name == "rwkv6-7b":
        require((n, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab)
                == (32, 4096, 64, 64, 14336, 65536), f"unexpected rwkv6-7b config {cfg}")
        return 10 * n + 1, {"wkv": n, "ssm": 0}
    require((n, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.ssm_state,
             cfg.window) == (32, 1600, 25, 5, 64, 5504, 32001, 16, 2048), f"unexpected hymba-1.5b config {cfg}")
    return 13 * n + 1, {"wkv": 0, "ssm": n}


_FAMILY = {"wkv": "wkv", "ssm": "ssm_scan"}  # launch counter -> selection family


def phase_serve(torch, mm, seq: dict, arch: str, policy=None) -> dict:
    """Serve 4 requests x 16 tokens at full width; every forward's launches checked.
    ``policy`` (default ``FixedPolicy()``) is installed in the engine's runtime."""
    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = registry.get(arch)
    per_forward, per_prefill = _expected(cfg)
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  {arch} full width: {cfg.n_layers} layers (no depth cut), d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16; weights {weight_bytes / 1e9:.2f} GB, "
          f"init {init_s:.1f}s")

    # A direct prefill: finite f32 logits over the padded vocab (also warms up).
    tokens = torch.randint(0, cfg.vocab, (1, 32), device="cuda")
    logits, _ = model.prefill(params, {"tokens": tokens}, 256)
    require(tuple(logits.shape) == (1, 1, cfg.padded_vocab()) and logits.dtype == torch.float32,
            f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    # (kind, size, GEMM launches, {sequence kernel: launches}, seconds) per forward
    events: list[tuple[str, int, int, dict, float]] = []
    mark = {"gemm": 0, "t": 0.0} | {name: 0 for name in seq}

    def record(kind):
        def hook(size):
            torch.cuda.synchronize()
            now, gemm = time.perf_counter(), mm.total_launches()
            counts = {name: mod.total_launches() for name, mod in seq.items()}
            events.append((kind, size, gemm - mark["gemm"], {k: v - mark[k] for k, v in counts.items()},
                           now - mark["t"]))
            mark.update(counts, gemm=gemm, t=now)
        return hook

    rt = KernelRuntime(name=f"chip_smoke[{arch}]")
    rt.install(FixedPolicy() if policy is None else policy)
    rt.set_selection_logging(True, cap=1 << 16)
    engine = ServingEngine(model, params, max_batch=4, cache_len=256, runtime=rt,
                           on_prefill=record("prefill"), on_decode=record("decode"))
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]

    # The main path: counts to 0 just before, read just after.
    torch.cuda.synchronize()
    mm.reset_launches()
    for mod in seq.values():
        mod.reset_launches()
    mark.update({name: 0 for name in seq}, gemm=0)
    mark["t"] = t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
    status = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mm.LAUNCHES)
    seq_launches = {name: dict(mod.LAUNCHES) for name, mod in seq.items()}

    require(status.completed == 4 and not status.exhausted, f"not every request completed: {status}")
    require(all(len(t.request.output) == 16 for t in tickets), "a request got fewer than 16 tokens")
    bad = [(kind, n) for kind, _, n, _, _ in events if n != per_forward]
    require(not bad, f"forwards with a GEMM launch count other than {per_forward}: {bad}")
    require(sum(launches.values()) == per_forward * len(events), "GEMM launches outside the forwards")
    stats = rt.shape_cache_stats()
    fam = stats["per_family"]
    for name in seq:
        want = per_prefill[name]
        bad = [(kind, c[name]) for kind, _, _, c, _ in events if c[name] != (want if kind == "prefill" else 0)]
        require(not bad, f"forwards with a {name} launch count other than {want} per prefill, 0 per decode: {bad}")
        require(sum(seq_launches[name].values()) == sum(e[3][name] for e in events),
                f"{name} launches outside the forwards")
    for op, n in [("matmul", sum(launches.values()))] + [(_FAMILY[k], sum(v.values())) for k, v in seq_launches.items()]:
        got = fam.get(op, {"hits": 0, "misses": 0})
        require(got["hits"] + got["misses"] == n, f"{op} selection not consulted on every launch: {got} vs {n}")
    require(fam["matmul"]["hits"] > 0, f"matmul shape cache never hit: {fam}")
    n_prefill = sum(1 for e in events if e[0] == "prefill")
    n_decode = len(events) - n_prefill
    # Launches per decode step, per (k, n), read from the selection log.
    counts: dict[str, int] = {}
    for op, problem, _cfg in rt.selection_log():
        # Decode GEMMs have 4 rows: a (4, 1, D) activation is (m, batch) = (1, 4), and Mamba's
        # output projection of a (4, D) one is (4, 1). Prefill GEMMs have >= 32 rows.
        if op == "matmul" and problem[0] * problem[3] == 4:
            kn = f"{problem[1]}x{problem[2]}"
            counts[kn] = counts.get(kn, 0) + 1
    per_step = {kn: c / n_decode for kn, c in counts.items()}
    decode_configs = sorted({(f"{p[1]}x{p[2]}", c.name()) for op, p, c in rt.selection_log()
                             if op == "matmul" and p[0] * p[3] == 4})
    require(sum(per_step.values()) == per_forward, f"decode-step GEMMs by shape {per_step} do not sum to {per_forward}")
    toks = sum(len(t.request.output) for t in tickets)
    prefill_ms = [round(sec * 1e3, 3) for kind, _, _, _, sec in events if kind == "prefill"]
    buckets = [size for kind, size, _, _, _ in events if kind == "prefill"]
    decode_ms = [sec * 1e3 for kind, _, _, _, sec in events if kind == "decode"]
    print(f"  served 4 requests (prompts {PROMPT_LENGTHS}) x 16 tokens: {toks} tokens in {wall:.3f}s "
          f"({toks / wall:.1f} tok/s); {n_prefill} prefills, {n_decode} decode steps")
    print(f"  prefill ms {prefill_ms} (buckets {buckets}); decode step ms median "
          f"{statistics.median(decode_ms):.3f} (min {min(decode_ms):.3f}, max {max(decode_ms):.3f})")
    seq_text = "; ".join(f"{name.upper()} launches: {per_prefill[name]} per prefill, 0 per decode step "
                         f"({sum(seq_launches[name].values())} in all)" for name in seq)
    print(f"  GEMM launches: {per_forward} per forward on every one of {len(events)} forwards; {seq_text}; "
          f"shape cache {stats['hits']} hits / {stats['misses']} misses")
    print(f"  decode-step GEMM launches per (k x n): {per_step}")
    return {
        "arch": arch, "n_layers": cfg.n_layers, "weight_bytes": weight_bytes, "tokens": toks, "wall_s": wall,
        "tok_per_s": toks / wall, "prefill_ms": prefill_ms, "prefill_buckets": buckets, "decode_ms": decode_ms,
        "launches": launches, "per_forward": per_forward, "forwards": len(events), "per_decode_step": per_step,
        "shape_cache": {k: stats[k] for k in ("hits", "misses")}, "per_family": fam,
        "decode_configs": decode_configs, "outputs": [list(t.request.output) for t in tickets],
        "engine": engine, "model": model, "params": params, "prompts": prompts,
    } | {f"{name}_launches": seq_launches[name] for name in seq} | {
        f"{name}_per_prefill": per_prefill[name] for name in seq}


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


def phase_seq_policy(mod, name: str, other, serve: dict) -> dict:
    """One request under ``FixedPolicy(<name>_config=other)`` launches the
    sequence kernel's config ``other`` n_layers times (its one prefill) and
    the default config not at all."""
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    default = getattr(mod, f"DEFAULT_{name.upper()}_CONFIG")
    require(other in mod.config_space() and other != default, f"bad choice of {name} config")
    rt = KernelRuntime(name=f"chip_smoke-{other.name()}")
    rt.install(FixedPolicy(**{f"{name}_config": other}))
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt)
    mod.reset_launches()
    engine.submit(serve["prompts"][0], max_new_tokens=4)
    engine.drain()
    got, n_default = mod.LAUNCHES[other.name()], mod.LAUNCHES[default.name()]
    require(got == serve[f"{name}_per_prefill"] and n_default == 0 and mod.total_launches() == got,
            f"FixedPolicy({name}_config={other.name()}) launched it {got} times, the default {n_default} times")
    print(f"  FixedPolicy({name}_config={other.name()}): {got} launches of it (one prefill), "
          f"{n_default} of {default.name()}")
    return {"config": other.name(), "launches": got, "default_launches": n_default}


def phase_hymba_cpu_vs_card(torch) -> dict:
    """Reduced hymba-1.5b at 4 layers (its layer 1 slides a 32-token window),
    served in process on cuda and on cpu from the same weights."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(registry.get("hymba-1.5b").reduced(), n_layers=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (20, 45)]
    streams = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        require(model._layer_kinds() == ["global", "swa", "global", "global"], "no sliding-window layer")
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        rt = KernelRuntime(name=f"chip_smoke-hymba4[{dev}]")
        rt.install(FixedPolicy())
        engine = ServingEngine(model, params, max_batch=2, cache_len=128, runtime=rt)
        ring = engine.pool.specs["['layer1']['k']"]
        require(ring.kind == "lane", f"the 32-token ring should be a lane leaf, got {ring}")
        tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
        status = engine.drain()
        require(status.completed == 2, f"hymba4 on {dev}: {status}")
        streams[dev] = [list(t.request.output) for t in tickets]
    if streams["cuda"] != streams["cpu"]:
        print(f"  cuda {streams['cuda']}\n  cpu  {streams['cpu']}")
    require(streams["cuda"] == streams["cpu"], "hymba4: greedy token streams differ between cuda and cpu")
    n_tok = sum(map(len, streams["cpu"]))
    print(f"  reduced hymba-1.5b at 4 layers, f32, prompts of 20 and 45 tokens (buckets 32, 64; ring 32): "
          f"cuda and cpu token streams equal ({n_tok} tokens)")
    return {"equal": True, "tokens": n_tok}


def phase_cpu_vs_card(arch: str) -> dict:
    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", arch, "--reduced", "--requests", "4", "--max-new-tokens", "8"]
    card = serve_cli.main(argv + ["--device", "cuda"])
    cpu = serve_cli.main(argv + ["--device", "cpu"])
    if card != cpu:
        _report_divergence(arch, card, cpu)
    require(card == cpu, f"{arch}: greedy token streams differ between cuda and cpu")
    print(f"  reduced {arch} f32: cuda and cpu token streams equal ({sum(map(len, cpu))} tokens)")
    return {"equal": True, "tokens": sum(map(len, cpu))}


def _report_divergence(arch, card, cpu) -> None:
    """Top-2 logit gap at the first token where the streams part."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    i = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
    j = next(j for j, (a, b) in enumerate(zip(card[i], cpu[i])) if a != b)
    cfg = registry.get(arch).reduced()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(len(card), 8))[i]
    seq = torch.as_tensor(np.concatenate([prompt, cpu[i][:j]]))[None]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        logits, _ = model.prefill(params, {"tokens": seq.to(dev)}, 128)
        top = torch.topk(logits[0, -1].float().cpu(), 2)
        print(f"  divergence at request {i} token {j}: {dev} top-2 {top.indices.tolist()} "
              f"gap {(top.values[0] - top.values[1]).item():.3g}")


def phase_profile(torch, serve: dict, n_prefill: int) -> dict:
    """Device time by kernel over ``n_prefill`` prefills and two decode steps
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine, prompts = serve["engine"], serve["prompts"]
    for p in prompts[n_prefill:]:
        engine.submit(p, max_new_tokens=4)
    engine.step()  # the other prefills + a decode step, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts[:n_prefill]:
            engine.submit(p, max_new_tokens=4)
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
        if "gemm_" in evt.key:
            name = "matmul (gemm_*_kernel)"
        elif "wkv_kernel" in evt.key:
            name = "wkv (wkv_kernel)"
        elif "ssm_kernel" in evt.key:
            name = "ssm_scan (ssm_kernel)"
        else:
            name = evt.key[:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    what = f"{n_prefill} prefill(s) + 2 decode steps" if n_prefill else "2 decode steps (batch 4)"
    if busy == 0:
        print("  the profiler recorded no device time: device busy share not measured")
        return {"window": what, "wall_ms": wall_ms, "busy_ms": None}
    print(f"  {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for name, ms in top:
        print(f"    {ms:9.3f} ms  {name}")
    return {"window": what, "wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms, "top": top,
            "wkv_ms": by_kernel.get("wkv (wkv_kernel)", 0.0), "ssm_ms": by_kernel.get("ssm_scan (ssm_kernel)", 0.0)}


def _time_ms(fn, n_warm=3, n_runs=20, queued=True) -> float:
    """Median time of one call of ``fn`` between CUDA events, by the tuning
    tables' clock (``core/gpubench.time_ms``: queued behind a device sleep
    unless ``queued`` is false), at the smoke's counts."""
    from repro_torch.core.gpubench import time_ms

    return time_ms(fn, n_warm=n_warm, n_runs=n_runs, queued=queued)


def phase_timing(torch, mm, per_step: dict, kn_list, ms=(4, 128)) -> list[dict]:
    rows = []
    g = torch.Generator(device="cuda").manual_seed(3)
    for m in ms:
        for k, n in kn_list:
            out_dtype = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16  # the vocab GEMM emits f32 logits
            a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            b_bytes = k * n * 2
            copies = max(1, -(-150_000_000 // b_bytes))  # rotate weights through > 3x the L2
            bs = [torch.randn(k, n, device="cuda", generator=g).bfloat16() for _ in range(copies)]
            out_bytes = m * n * (4 if out_dtype == torch.float32 else 2)
            flops = 2 * m * k * n
            nbytes = m * k * 2 + b_bytes + out_bytes
            bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            per_cfg = {
                cfg.name(): _time_ms(lambda i, c=cfg: mm.matmul_cuda(a, bs[i % copies], c, out_dtype=out_dtype))
                for cfg in mm.config_space()
            }
            call = _time_ms(lambda i: mm.matmul_cuda(a, bs[i % copies], out_dtype=out_dtype), queued=False)
            plain = _time_ms(lambda i: mm.matmul_plain(a, bs[i % copies], out_dtype))
            library = _time_ms(lambda i: torch.matmul(a, bs[i % copies]).to(out_dtype))
            best = min(per_cfg, key=per_cfg.get)
            row = {
                "m": m, "k": k, "n": n, "out": str(out_dtype).replace("torch.", ""),
                "ms": per_cfg[mm.DEFAULT_CONFIG.name()], "best_config": best, "best_ms": per_cfg[best],
                "call_ms": call, "plain_ms": plain, "library_ms": library, "bound_ms": bound,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                "launches_per_decode_step": per_step.get(f"{k}x{n}", 0) if m == 4 else None,
                "per_config_ms": per_cfg,
            }
            rows.append(row)
            print(f"  m={m:<4} k={k:<6} n={n:<6} {row['out']:>8}: kernel {row['ms']:.4f} ms "
                  f"(best {best} {per_cfg[best]:.4f}; one call from idle {call:.4f}), bound {bound:.4f} ms "
                  f"({row['bound_by']}), plain {plain:.4f}, torch.matmul {library:.4f}"
                  + (f", {row['launches_per_decode_step']:g} launches/decode step" if m == 4 else ""))
            del bs
    return rows


def phase_wkv_timing(torch, wk) -> list[dict]:
    """The WKV kernel at what rwkv6-7b's batch-1 prefill gives it (bf16 r/k/v
    and u, f32 logw, a zero f32 state), every config, beside its bound."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, hd = 1, 64, 64
    for s in (32, 64, 128):
        r, k, v, logw, u, _ = _wkv_inputs(torch, g, b, s, h, hd, torch.bfloat16, "dist", False)
        state = torch.zeros((b, h, hd, hd), device="cuda")
        args = (r, k, v, logw, u, state)
        # Each input read once, each output written once.
        nbytes = sum(t.numel() * t.element_size() for t in args) + b * s * h * hd * 4 + b * h * hd * hd * 4
        # The recurrent form's count, the fewest for this function: per token and head,
        # o = r.S (2 hd^2), S = w (.) S + k v^T (3 hd^2), the u-bonus (4 hd).
        ops = b * s * h * (5 * hd * hd + 4 * hd)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: wk.wkv_cuda(*args, config=c))
                   for cfg in wk.config_space()}
        call = _time_ms(lambda i: wk.wkv_cuda(*args), queued=False)
        plain = _time_ms(lambda i: wk.wkv_plain(*args))
        best = min(per_cfg, key=per_cfg.get)
        row = {"s": s, "shape": [b, s, h, hd], "ms": per_cfg[wk.DEFAULT_WKV_CONFIG.name()], "best_config": best,
               "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain, "bound_ms": bound,
               "bytes": nbytes, "ops": ops,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
               "per_config_ms": per_cfg}
        rows.append(row)
        cfgs = ", ".join(f"{name} {ms:.4f}" for name, ms in per_cfg.items())
        print(f"  (1, {s}, 64, 64) bf16: {cfgs} ms; bound {bound:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop f32); one {wk.DEFAULT_WKV_CONFIG.name()} call from idle "
              f"{call:.4f} ms; plain {plain:.4f} ms")
    return rows


def phase_ssm_timing(torch, ss) -> list[dict]:
    """The SSM kernel at what hymba-1.5b's batch-1 prefill gives it (f32
    dtx, dta, b, c and no initial state), every config, beside its bound."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(8)
    b, d, n = 1, 1600, 16
    for s in (32, 64, 128):
        args = _ssm_inputs(torch, g, b, s, d, n, False)[:4]
        # Each input read once (no initial state on the served path), y and the final state written once.
        nbytes = sum(t.numel() * t.element_size() for t in args) + b * s * d * 4 + b * d * n * 4
        # Per (t, channel, state): exp, dtx * b, the fma into h, h * c and its sum: 6 f32 operations.
        ops = 6 * b * s * d * n
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: ss.ssm_cuda(*args, config=c))
                   for cfg in ss.config_space()}
        call = _time_ms(lambda i: ss.ssm_cuda(*args), queued=False)
        plain = _time_ms(lambda i: ss.ssm_plain(*args))
        best = min(per_cfg, key=per_cfg.get)
        row = {"s": s, "shape": [b, s, d, n], "ms": per_cfg[ss.DEFAULT_SSM_CONFIG.name()], "best_config": best,
               "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain, "bound_ms": bound,
               "bytes": nbytes, "ops": ops,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
               "per_config_ms": per_cfg}
        rows.append(row)
        cfgs = ", ".join(f"{name} {ms:.4f}" for name, ms in per_cfg.items())
        print(f"  (1, {s}, 1600, 16) f32: {cfgs} ms; bound {bound:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop f32); one {ss.DEFAULT_SSM_CONFIG.name()} call from idle "
              f"{call:.4f} ms; plain {plain:.4f} ms")
    return rows


def _attention_bound(sq: int, skv: int, d: int, heads: int, causal: bool) -> tuple[float, str]:
    """(least ms, what bounds it) for one bf16 attention call: the larger of
    the useful FLOPs (both products over the visible (row, column) pairs of
    this call's mask) over the bf16 tensor-core peak and the bytes of q, k, v
    and the output (each read or written once) over the memory rate."""
    if causal:  # row i sees min(skv, i + skv - sq + 1) columns; rows below sq - skv see none
        pairs = sum(min(skv, i + skv - sq + 1) for i in range(max(0, sq - skv), sq))
    else:
        pairs = sq * skv
    flops = 4.0 * pairs * d * heads
    nbytes = (2 * sq + 2 * skv) * d * heads * 2
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _attn_inputs(torch, g, lead, sq, skv, d, dtype):
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g, dtype=torch.float32).to(dtype)
    return randn(*lead, sq, d), randn(*lead, skv, d), randn(*lead, skv, d)


def _plain_by_head(at, q, k, v, causal=True):
    """The plain version head by head (its f32 logits of a 32768 x 32768 head
    take 4.3 GB; of all 32 heads at once, 137 GB)."""
    out = q.new_empty(q.shape)
    for h in range(q.shape[1]):
        out[:, h] = at.attention_plain(q[:, h], k[:, h], v[:, h], causal=causal)
    return out


def phase_attention_vs_plain(torch, at) -> dict:
    """Every compiled attention config against the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = [((2, 3), sq, skv) for sq, skv in ((1, 1), (1, 300), (7, 7), (50, 130), (128, 128), (64, 1000),
                                                 (40, 24))]
    shapes += [((1, 32), 1, 32768), ((1, 32), 4096, 4096)]  # what granite-8b serving would give it
    worst = {name: {"rel": 0.0, "abs": 0.0} for name in ATTN_TOL}
    checks = 0
    for lead, sq, skv in shapes:
        for d in (64, 128):
            for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                q, k, v = _attn_inputs(torch, g, lead, sq, skv, d, dtype)
                for causal in (True, False):
                    want = at.attention_plain(q, k, v, causal=causal).float()
                    scale = want.abs().max().item()
                    for cfg in at.config_space():
                        got = at.attention_cuda(q, k, v, cfg, causal=causal).float()
                        where = f"{cfg.name()} {name} {(*lead, sq, skv, d)} causal={causal}"
                        require(bool(torch.isfinite(got).all()), f"{where}: output not finite")
                        if causal and sq > skv:
                            require(bool((got[..., : sq - skv, :] == 0).all()), f"{where}: rows that see "
                                                                                  f"nothing are not zeros")
                        err = (got - want).abs().max().item()
                        require(err <= ATTN_TOL[name] * scale, f"{where}: rel err {err / scale:.3g} > "
                                                               f"{ATTN_TOL[name]}")
                        w = worst[name]
                        w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                        checks += 1
                del q, k, v
    torch.cuda.synchronize()
    for name, w in worst.items():
        print(f"  {name}: worst rel err {w['rel']:.3g} (limit {ATTN_TOL[name]}), worst abs err {w['abs']:.3g}")
    print(f"  {checks} checks ({len(shapes)} shapes x 2 head dims x 2 dtypes x 2 masks x {len(at.config_space())} "
          f"configs): every output finite; at (40, 24) causal the 16 rows that see nothing are zeros")
    return {"worst": worst, "checks": checks}


def phase_tune(torch, mm, at) -> dict:
    """The tuning entry point on the card, in process: measured tables ->
    cluster-select -> decision tree -> build/deploy_h100.json."""
    from repro_torch.launch import tune as tune_cli

    mm.reset_launches()
    at.reset_launches()
    t0 = time.perf_counter()
    result = tune_cli.main(["--archs", ",".join(TUNED_ARCHS), "--families", "attention", "--n-kernels", "4",
                            "--out", str(DEPLOY_PATH)])
    wall = time.perf_counter() - t0
    dep = result.deployment
    require(DEPLOY_PATH.is_file(), f"{DEPLOY_PATH} not written")
    require(result.train.source == "measured" and dep.device.startswith("gpu_"),
            f"not a measured card table: {result.train.source} on {dep.device}")
    lineage, tables = dep.meta["tuning_lineage"], dep.meta["tables"]
    require(set(tables) == {"matmul", "attention"}, f"families tuned: {sorted(tables)}")
    require(tables["matmul"][1] == len(mm.config_space()) and tables["attention"][1] == len(at.config_space()),
            f"tables {tables}")
    for fam in ("matmul", "attention"):
        require(lineage[fam]["measured_fraction"] == 1.0, f"{fam}: not every cell measured: {lineage[fam]}")
    out = {
        "device": dep.device, "wall_s": wall, "tables": tables,
        "measure_seconds": {fam: lineage[fam]["measure_seconds"] for fam in tables},
        "deployed": {fam: [c.name() for c in dep.family_tuning(fam).configs] for fam in tables},
        "fractions": {"matmul": [result.oracle_fraction, result.classifier_fraction]} | {
            name: [r.oracle_fraction, r.classifier_fraction] for name, r in result.family_results.items()},
        "launches_while_measuring": {"matmul": mm.total_launches(), "attention": at.total_launches()},
    }
    print(f"  tuned on {dep.device} in {wall:.1f}s; tables {tables} (problems x configs), measured in "
          f"{out['measure_seconds']} s; launches while measuring {out['launches_while_measuring']}")
    return out


def phase_quickstart(torch, mm, at, ops) -> dict:
    """The quickstart's path on the card: the tuned Deployment in a fresh
    runtime, ops.attention at every harvested attention problem at (1, 32)
    heads in bf16 and ops.matmul at the quickstart's two shapes, each call
    launching exactly the config the Deployment's tree names."""
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.core.attnmodel import harvest_attn_problems
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import KernelRuntime

    dep = Deployment.load(DEPLOY_PATH)
    rt = KernelRuntime(name="chip_smoke-tuned")
    rt.install(dep)
    rt.set_selection_logging(True)
    problems = harvest_attn_problems(list(TUNED_ARCHS))
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(12)
    heads = 32
    # The main path: counts to 0 just before, read just after; every call's
    # output is checked afterwards, and the timing launches come after the read.
    torch.cuda.synchronize()
    at.reset_launches()
    mm.reset_launches()
    calls = []
    for sq, skv, d in problems:
        q, k, v = _attn_inputs(torch, g, (1, heads), sq, skv, d, torch.bfloat16)
        want_cfg = dep.select_attention(sq, skv, d)
        for _ in range(2):  # the second call is a shape-cache hit
            before = dict(at.LAUNCHES)
            with rt.activate():
                got = ops.attention(q, k, v)
            delta = {n: c - before[n] for n, c in at.LAUNCHES.items() if c != before[n]}
            require(delta == {want_cfg.name(): 1}, f"ops.attention at {(sq, skv, d)} launched {delta}, the tree "
                                                   f"names {want_cfg.name()}")
        calls.append(((sq, skv, d), want_cfg, (q, k, v), got))
    mm_calls = []
    for m, k, n in ((512, 784, 512), (1, 4096, 512)):  # the quickstart's two GEMMs
        a = torch.randn((m, k), device="cuda", generator=g).bfloat16()
        b = torch.randn((k, n), device="cuda", generator=g).bfloat16()
        want_cfg = dep.select_matmul(m, k, n, 1)
        before = dict(mm.LAUNCHES)
        with rt.activate():
            got = ops.matmul(a, b)
        delta = {name: c - before[name] for name, c in mm.LAUNCHES.items() if c != before[name]}
        require(delta == {want_cfg.name(): 1}, f"ops.matmul at {(m, k, n)} launched {delta}, the tree names "
                                               f"{want_cfg.name()}")
        mm_calls.append(((m, k, n, 1), want_cfg, a, b, got))
    torch.cuda.synchronize()
    launches = {"attention": dict(at.LAUNCHES), "matmul": dict(mm.LAUNCHES)}
    stats = rt.shape_cache_stats()["per_family"]
    require(stats["attention"]["misses"] == len(problems) and stats["attention"]["hits"] == len(problems),
            f"attention shape cache {stats['attention']}")

    rows, worst = [], {"rel": 0.0, "abs": 0.0}
    while calls:
        (sq, skv, d), cfg, (q, k, v), got = calls.pop(0)
        want = _plain_by_head(at, q, k, v).float()
        got = got.float()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["bf16"] * scale,
                f"ops.attention at {(sq, skv, d)}: rel err {err / scale:.3g} > {ATTN_TOL['bf16']}")
        worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
        bound, bound_by = _attention_bound(sq, skv, d, heads, True)
        mask = causal_lower_right(sq, skv)
        row = {"problem": [sq, skv, d], "config": cfg.name(), "rel_err": err / scale,
               "ms": _time_ms(lambda i: at.attention_cuda(q, k, v, cfg), n_runs=10),
               "plain_ms": _time_ms(lambda i: _plain_by_head(at, q, k, v), n_warm=1, n_runs=3),
               "library_ms": _time_ms(lambda i: sdpa(q, k, v, attn_mask=mask), n_runs=10),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        print(f"  {(sq, skv, d)}: {row['config']} (tree), rel err {row['rel_err']:.2g}; kernel {row['ms']:.4f} ms, "
              f"bound {bound:.4f} ({bound_by}), plain {row['plain_ms']:.3f}, SDPA {row['library_ms']:.4f}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    mm_rows = []
    for problem, cfg, a, b, got in mm_calls:
        want = mm.matmul_plain(a, b).float()
        scale = want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        require(err <= TOL[("bf16", "bf16")] * scale, f"ops.matmul at {problem}: rel err {err / scale:.3g}")
        mm_rows.append({"problem": list(problem), "config": cfg.name(), "rel_err": err / scale})
    print(f"  ops.matmul at the quickstart's shapes: {[(r['problem'], r['config']) for r in mm_rows]}")
    print(f"  attention launches {sum(launches['attention'].values())} "
          f"({ {n: c for n, c in launches['attention'].items() if c} }); shape cache {stats}")
    return {"rows": rows, "matmul": mm_rows, "worst": worst, "launches": launches, "shape_cache": stats}


def phase_attention_timing(torch, at) -> list[dict]:
    """Every config at the served shapes of granite-8b (32 heads of 128) and
    hymba-1.5b (25 heads of 64): causal prefill S in {512, 2048, 4096} and a
    decode step at 4096 and 32768 cached tokens, bf16."""
    from torch.nn.attention.bias import causal_lower_right

    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for arch, heads, d in (("granite-8b", 32, 128), ("hymba-1.5b", 25, 64)):
        for sq, skv in ((512, 512), (2048, 2048), (4096, 4096), (1, 4096), (1, 32768)):
            q, k, v = _attn_inputs(torch, g, (1, heads), sq, skv, d, torch.bfloat16)
            bound, bound_by = _attention_bound(sq, skv, d, heads, True)
            per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: at.attention_cuda(q, k, v, c))
                       for cfg in at.config_space()}
            call = _time_ms(lambda i: at.attention_cuda(q, k, v), queued=False)
            plain = _time_ms(lambda i: at.attention_plain(q, k, v), n_runs=5)
            mask = causal_lower_right(sq, skv)
            library = _time_ms(lambda i: sdpa(q, k, v, attn_mask=mask))
            best = min(per_cfg, key=per_cfg.get)
            row = {"arch": arch, "shape": [1, heads, sq, skv, d], "ms": per_cfg[at.DEFAULT_ATTN_CONFIG.name()],
                   "best_config": best, "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain,
                   "library_ms": library, "bound_ms": bound, "bound_by": bound_by, "per_config_ms": per_cfg}
            rows.append(row)
            print(f"  {arch} (1, {heads}, {sq}, {skv}, {d}): default {row['ms']:.4f} ms, best {best} {per_cfg[best]:.4f}; "
                  f"bound {bound:.4f} ({bound_by}); one call from idle {call:.4f}; plain {plain:.3f}; "
                  f"SDPA {library:.4f}")
            del q, k, v
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _release(torch, serve: dict) -> None:
    for key in ("engine", "model", "params", "prompts"):
        serve.pop(key)
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as at
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk

    t_start = time.perf_counter()
    print("[1] card")
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    print("[2] build")
    t0 = time.perf_counter()
    _build.load_all(["matmul", "wkv", "ssm", "attention"])
    tiles, wkv_cfgs, ssm_cfgs = mm.compiled_tiles(), wk.compiled_configs(), ss.compiled_configs()
    attn_cfgs = at.compiled_configs()
    print(f"  matmul.cu, wkv.cu, ssm.cu and attention.cu -> sm_90a in {time.perf_counter() - t0:.1f}s (nvcc in "
          f"parallel: {', '.join(f'{k} {v:.1f}s' for k, v in _build.build_seconds.items())})")
    print(f"  matmul tiles (bm, bn, bk, smem bf16, smem f32): {tiles}")
    print(f"  wkv instantiations (chunk, hd, smem): {wkv_cfgs}")
    print(f"  ssm instantiations (block_d, chunk, N, threads): {ssm_cfgs}")
    print(f"  attention instantiations (block_q, block_kv, hd, threads, smem bf16, smem f32): {attn_cfgs}")
    for name in ("matmul", "wkv", "ssm", "attention"):
        log = _build.build_log(name).splitlines()
        regs = [line.split(":", 1)[1].strip() for line in log if "registers" in line]
        spills = sorted({line.strip() for line in log if "spill" in line and "0 bytes spill" not in line})
        print(f"  ptxas {name}: {len(regs)} kernels; {sorted(set(regs))}; spills {spills or 'none'}")

    print("[3] GEMM against plain")
    errors = phase_kernel_vs_plain(torch, mm)
    print("[3b] WKV against plain")
    wkv_errors = phase_wkv_vs_plain(torch, wk)
    print("[3c] SSM against plain")
    ssm_errors = phase_ssm_vs_plain(torch, ss)
    seq = {"wkv": wk, "ssm": ss}

    print("[4] full-width granite-8b serving")
    serve = phase_serve(torch, mm, seq, "granite-8b")
    print("[5] selection reaches the kernel")
    policy = phase_policy(mm, serve)
    print("[5b] where a granite-8b decode step's time goes")
    profile = phase_profile(torch, serve, 0)
    _release(torch, serve)  # granite's weights go before rwkv6-7b's load

    print("[6] cpu against card, granite-8b")
    parity = phase_cpu_vs_card("granite-8b")

    print("[7] GEMM timing, granite-8b shapes (bf16, DEFAULT_CONFIG = the config served)")
    rows = phase_timing(torch, mm, serve["per_decode_step"], GRANITE_KN)

    print("[8] full-width rwkv6-7b serving")
    rwkv = phase_serve(torch, mm, seq, "rwkv6-7b")
    print("[9] selection reaches the WKV kernel")
    wkv_policy = phase_seq_policy(wk, "wkv", wk.WkvConfig(64), rwkv)
    print("[9b] where an rwkv6-7b prefill's and decode step's time goes")
    rwkv_profile = phase_profile(torch, rwkv, 1)
    _release(torch, rwkv)

    print("[10] cpu against card, rwkv6-7b")
    rwkv_parity = phase_cpu_vs_card("rwkv6-7b")

    print("[11] WKV timing (DEFAULT_WKV_CONFIG = the config served), GEMM timing at rwkv6-7b decode shapes")
    wkv_rows = phase_wkv_timing(torch, wk)
    rwkv_rows = phase_timing(torch, mm, rwkv["per_decode_step"], RWKV_KN, ms=(4,))

    print("[12] full-width hymba-1.5b serving")
    hymba = phase_serve(torch, mm, seq, "hymba-1.5b")
    print("[13] selection reaches the SSM kernel")
    ssm_policy = phase_seq_policy(ss, "ssm", ss.SsmConfig(8, 16), hymba)
    print("[13b] where a hymba-1.5b prefill's and decode step's time goes")
    hymba_profile = phase_profile(torch, hymba, 1)
    _release(torch, hymba)

    print("[14] cpu against card, hymba-1.5b at 4 layers")
    hymba_parity = phase_hymba_cpu_vs_card(torch)

    print("[15] SSM timing (DEFAULT_SSM_CONFIG = the config served), GEMM timing at hymba-1.5b decode shapes")
    ssm_rows = phase_ssm_timing(torch, ss)
    hymba_rows = phase_timing(torch, mm, hymba["per_decode_step"], HYMBA_KN, ms=(4,))

    print("[16] attention against plain")
    attn_errors = phase_attention_vs_plain(torch, at)
    print("[17] tune on the card: measured tables -> cluster-select -> decision tree -> Deployment")
    tuning = phase_tune(torch, mm, at)
    print("[18] the quickstart's path: the tuned Deployment in a fresh runtime, ops.attention and ops.matmul")
    quick = phase_quickstart(torch, mm, at, ops)
    print("[19] full-width granite-8b served under the tuned Deployment")
    from repro_torch.core.dispatch import Deployment

    tuned = phase_serve(torch, mm, seq, "granite-8b", policy=Deployment.load(DEPLOY_PATH))
    print("[19b] where a tuned granite-8b decode step's time goes")
    tuned_profile = phase_profile(torch, tuned, 0)
    _release(torch, tuned)
    # One granite decode step's GEMMs at m=4: sum of count x time over the shapes it launches,
    # under the default config, each shape's best compiled config, and the tree's choices.
    step = [r for r in rows if r["m"] == 4]
    total = lambda key: sum(r[key] * r["launches_per_decode_step"] for r in step)
    tree_cfg = dict(tuned["decode_configs"])
    require(len(tree_cfg) == len(tuned["decode_configs"]), f"one (k, n) decode GEMM selected two configs: "
                                                            f"{tuned['decode_configs']}")
    tuned_step_ms = sum(r["per_config_ms"][tree_cfg[f"{r['k']}x{r['n']}"]] * r["launches_per_decode_step"]
                        for r in step)
    tuned["gemm_step_ms"] = {"default": total("ms"), "best_per_shape": total("best_ms"), "tree": tuned_step_ms,
                             "bound": total("bound_ms")}
    tuned["streams_equal_phase_4"] = tuned["outputs"] == serve["outputs"]
    split = {name: n for name, n in tuned["launches"].items() if n}
    print(f"  GEMM launches by config: {split}; decode-step GEMM configs {tree_cfg}")
    print(f"  one decode step's GEMMs (CUDA-event device time from phase 7, summed over shapes): tree "
          f"{tuned_step_ms:.2f} ms, default {total('ms'):.2f}, best per shape {total('best_ms'):.2f}, "
          f"bound {total('bound_ms'):.2f}; greedy streams equal phase 4's: {tuned['streams_equal_phase_4']}")
    print("[20] attention timing at the served shapes")
    attn_rows = phase_attention_timing(torch, at)
    # The rwkv6-7b run's WKV launches: n_layers per prefill, at each prefill's bucket.
    by_s = {r["s"]: r for r in wkv_rows}
    wkv_total = lambda key: rwkv["wkv_per_prefill"] * sum(by_s[s][key] for s in rwkv["prefill_buckets"])
    # The hymba-1.5b run's SSM launches: n_layers per prefill, at each prefill's bucket.
    ssm_by_s = {r["s"]: r for r in ssm_rows}
    ssm_total = lambda key: hymba["ssm_per_prefill"] * sum(ssm_by_s[s][key] for s in hymba["prefill_buckets"])
    gemm_launches = {run["arch"]: sum(run["launches"].values()) for run in (serve, rwkv, hymba)}
    gemm_launches["granite-8b (tuned)"] = sum(tuned["launches"].values())
    gemm_launches["quickstart"] = sum(quick["launches"]["matmul"].values())
    kernels = {"kernels": [{
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:120",
        "launches": sum(gemm_launches.values()),
        "launches_by_path": gemm_launches,
        "max_abs_err": max(w["abs"] for k, w in errors.items() if k != "checks"),
        "max_rel_err": max(w["rel"] for k, w in errors.items() if k != "checks"),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes",
        "library_ms": total("library_ms"),
        "timed_as": "all GEMMs of one granite-8b decode step (batch 4), summed over shapes, DEFAULT_CONFIG",
        "tuned_ms": tuned_step_ms,
    }, {
        "name": "wkv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:114",
        "launches": sum(rwkv["wkv_launches"].values()),
        "max_abs_err": wkv_errors["abs"],
        "max_rel_err": wkv_errors["rel"],
        "ms": wkv_total("ms"),
        "plain_ms": wkv_total("plain_ms"),
        "bound_ms": wkv_total("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in wkv_rows) else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunked WKV recurrence",
        "timed_as": f"all WKV launches of the rwkv6-7b run's prefills (buckets {rwkv['prefill_buckets']}, "
                    f"{rwkv['wkv_per_prefill']} each), summed from per-length medians",
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm.cu",
        "replaces": "src/repro/kernels/ssm.py:90",
        "launches": sum(hymba["ssm_launches"].values()),
        "max_abs_err": ssm_errors["abs"],
        "max_rel_err": ssm_errors["rel"],
        "ms": ssm_total("ms"),
        "plain_ms": ssm_total("plain_ms"),
        "bound_ms": ssm_total("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in ssm_rows) else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the selective scan",
        "timed_as": f"all SSM launches of the hymba-1.5b run's prefills (buckets {hymba['prefill_buckets']}, "
                    f"{hymba['ssm_per_prefill']} each), summed from per-length medians",
    }, {
        "name": "attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention.py:98",
        "launches": sum(quick["launches"]["attention"].values()),
        "max_abs_err": max([w["abs"] for w in attn_errors["worst"].values()] + [quick["worst"]["abs"]]),
        "max_rel_err": max([w["rel"] for w in attn_errors["worst"].values()] + [quick["worst"]["rel"]]),
        "ms": sum(r["ms"] for r in quick["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in quick["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in quick["rows"]),
        "bound_by": max(("operations", "bytes"), key=lambda b: sum(r["bound_ms"] for r in quick["rows"]
                                                                    if r["bound_by"] == b)),
        "library_ms": sum(r["library_ms"] for r in quick["rows"]),
        "library_note": "scaled_dot_product_attention with causal_lower_right (a yardstick only)",
        "timed_as": f"phase 18's ops.attention calls: one per harvested attention problem of {', '.join(TUNED_ARCHS)} "
                    f"({len(quick['rows'])}) at (1, 32) heads, bf16, causal, under the tree's config, summed "
                    f"(the run made each call twice, the second a shape-cache hit)",
    }]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": _build.build_seconds, "errors": errors, "wkv_errors": wkv_errors,
        "serve": serve, "policy": policy, "profile": profile, "cpu_vs_card": parity, "timing": rows,
        "rwkv_serve": rwkv, "wkv_policy": wkv_policy, "rwkv_profile": rwkv_profile,
        "rwkv_cpu_vs_card": rwkv_parity, "wkv_timing": wkv_rows, "rwkv_timing": rwkv_rows,
        "ssm_errors": ssm_errors, "hymba_serve": hymba, "ssm_policy": ssm_policy, "hymba_profile": hymba_profile,
        "hymba_cpu_vs_card": hymba_parity, "ssm_timing": ssm_rows, "hymba_timing": hymba_rows,
        "attention_errors": attn_errors, "tuning": tuning, "quickstart": quick, "tuned_serve": tuned,
        "tuned_profile": tuned_profile,
        "attention_timing": attn_rows,
        "kernels": kernels["kernels"], "seconds": time.perf_counter() - t_start,
    }, indent=1, default=str))
    print(f"[21] done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
