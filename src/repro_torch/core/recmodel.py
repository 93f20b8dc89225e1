"""The recurrence families: WKV and selective-scan features, harvests and H100 models.

The counterpart of ``repro/core/recmodel.py``.  The problem of the WKV family
is ``(s, hd)`` (sequence length x head dim), that of the selective scan
``(s, d)`` (sequence length x inner width); the features are the
reference's.  The harvests are the reference's over the port's registry, so
both give the same problem lists for every arch the two registries hold.

The families' tables are measured on the card (``core/gpubench.py``).  The
models below are their ``model_matrix``: what the staged pipeline can know
before anything runs, on the H100 :class:`~repro_torch.core.perfmodel.DeviceModel`.
They follow the port's kernels, not the reference's VMEM tiling:

  * **WKV** (``csrc/wkv.cu``): a state pass, 2 CTAs a head at hd 64, walks
    the chunks in order (a chain of one L-deep update per chunk), then an
    output kernel computes every (head, chunk, value block) at once; f32 FMA
    throughout (no tensor cores); bytes: r/k/v in their dtype, logw in f32,
    the f32 output, and the ``hs`` workspace written once and read once.
  * **Selective scan** (``csrc/ssm.cu``, the fused entry ``mamba_layer``
    serves through): B x ceil(d / block_d) CTAs, each walking its channels
    through the sequence chunk by chunk, a chunk's ``chunk`` / 8 time groups
    in parallel and then folded in order; a long call cut into segments
    across CTAs (``kernels/ssm.py::ssm_segments``), which runs every segment
    but the last twice; bytes: x, dt, b, c read once, y written once.

Both time a call at the leading dims :mod:`~repro_torch.core.gpubench` times
it at, and rate it in the reference's useful FLOPs: ``8 s hd^2`` per head
for WKV, ``6 s d N`` for the scan.  The per-step latencies are model
assumptions, named as such, not measurements.
"""
from __future__ import annotations

import math

import numpy as np

from .perfmodel import H100_SXM5, DeviceModel, device_model

WkvProblem = tuple[int, int]  # (seq_len, head_dim)
SsmProblem = tuple[int, int]  # (seq_len, d_inner)

WKV_FEATURE_NAMES = ("log2_s", "log2_hd", "log2_s_over_hd")
SSM_FEATURE_NAMES = ("log2_s", "log2_d", "log2_s_over_d")

SSM_STATE_N = 16  # the served state width (hymba-1.5b)

# Model assumptions (not measurements of this model's runs): the device time of one
# dependent step of each kernel's chain, in cycles of the boost clock, set from the served
# per-call times PERF.md records (a few microseconds a call at S = 32-128).
WKV_CHUNK_STEP_CYCLES = 40  # state pass: a handshake and one position of the L-deep update
SSM_STEP_CYCLES = 100  # scan: one step of a time group (ex2, fma, multiply, loads) or one fold
SSM_THREADS_PER_SM = 2048


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _log2_features(p: np.ndarray) -> np.ndarray:
    a, b = p.T
    return np.column_stack([np.log2(a), np.log2(b), np.log2(a / b)])


def wkv_problem_features(problems: list[WkvProblem]) -> np.ndarray:
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 2)
    if p.size == 0:
        return np.zeros((0, len(WKV_FEATURE_NAMES)))
    return _log2_features(np.maximum(p, 1.0))


def ssm_problem_features(problems: list[SsmProblem]) -> np.ndarray:
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 2)
    if p.size == 0:
        return np.zeros((0, len(SSM_FEATURE_NAMES)))
    return _log2_features(np.maximum(p, 1.0))


# ---------------------------------------------------------------------------
# harvests (the reference's, over the port's registry)
# ---------------------------------------------------------------------------
def harvest_wkv_problems(arch_ids: list[str] | None = None) -> list[WkvProblem]:
    """WKV shapes the attention-free architectures actually launch."""
    from ..configs import registry

    arch_ids = arch_ids or list(registry.ARCHS)
    out: set[WkvProblem] = set()
    for arch in arch_ids:
        cfg = registry.get(arch)
        if cfg.family != "ssm":  # RWKV-style time-mix archs only
            continue
        hd = cfg.head_dim
        for shape in registry.shapes_for(arch):
            sp = registry.SHAPES[shape]
            if sp.kind == "decode":
                out.add((1, hd))
            else:
                out.add((sp.seq_len, hd))
                out.add((min(2048, sp.seq_len), hd))  # chunked-prefill sub-blocks
    return sorted(out)


def harvest_ssm_problems(arch_ids: list[str] | None = None) -> list[SsmProblem]:
    """Selective-scan shapes the hybrid (Mamba-head) architectures launch.

    Decode is excluded: the decode step advances the state inline and never
    dispatches the scan.
    """
    from ..configs import registry

    arch_ids = arch_ids or list(registry.ARCHS)
    out: set[SsmProblem] = set()
    for arch in arch_ids:
        cfg = registry.get(arch)
        if cfg.family != "hybrid":
            continue
        d = cfg.d_model
        for shape in registry.shapes_for(arch):
            sp = registry.SHAPES[shape]
            if sp.kind == "decode":
                continue
            out.add((sp.seq_len, d))
            out.add((min(2048, sp.seq_len), d))
    return sorted(out)


def wkv_heads(hd: int) -> int:
    """Heads a WKV problem of head dim ``hd`` is timed at: those of the first
    registered RWKV arch with that head dim (rwkv6-7b: 64 of 64), else
    4096 / hd."""
    from ..configs import registry

    for cfg in registry.ARCHS.values():
        if cfg.family == "ssm" and cfg.head_dim == hd:
            return cfg.n_heads
    return max(1, 4096 // hd)


# ---------------------------------------------------------------------------
# WKV (csrc/wkv.cu)
# ---------------------------------------------------------------------------
def predict_wkv_time(problem: WkvProblem, cfg, device: DeviceModel = H100_SXM5, *,
                     heads: int | None = None, rkv_bytes: int = 2) -> float:
    """Predicted seconds of one ``wkv_cuda`` call at (1, S, heads, hd); inf for
    a config the card cannot launch."""
    from ..kernels.wkv import launch_chunk, value_block

    s, hd = problem
    h = heads if heads is not None else wkv_heads(hd)
    if cfg.smem_bytes(hd) > device.smem_per_cta:
        return math.inf
    L = launch_chunk(cfg, max(s, 1))
    n_chunks = _ceil(max(s, 1), L)
    per_sm_f32 = device.f32_flops / device.sms
    # State pass: 2 CTAs a head (KR = hd / 2 key rows), a chain over the chunks.
    kr = hd // 2 if hd > 16 else hd
    state_ctas = h * (hd // kr)
    state_waves = _ceil(state_ctas, device.sms)
    step = 2.0 * L * kr * hd * 2 / per_sm_f32  # the update's FMAs for one chunk
    t_state = state_waves * n_chunks * (step + WKV_CHUNK_STEP_CYCLES * L / device.clock_hz)
    # Output kernel: every (head, chunk, value block) at once, f32 FMA.
    vb = value_block(L, hd)
    out_ctas = h * n_chunks * (hd // vb)
    cta_flops = 2.0 * (L * L * hd + L * hd * vb + L * L * vb)
    t_out = _ceil(out_ctas, device.sms) * cta_flops / per_sm_f32
    # Bytes: r/k/v in their dtype, logw f32, o f32, the state out, hs written then read.
    tokens = s * h * hd
    traffic_state = tokens * (2 * rkv_bytes + 4) + n_chunks * h * hd * hd * 4
    traffic_out = tokens * (2 * rkv_bytes + 4 + 4) + n_chunks * h * hd * hd * 4
    return (max(t_state, traffic_state / device.hbm_bw) + max(t_out, traffic_out / device.hbm_bw)
            + 2 * device.launch_overhead)


def wkv_flops(s: int, hd: int, heads: int) -> float:
    """The reference's useful FLOPs of one call: 8 s hd^2 per head."""
    return 8.0 * s * hd * hd * heads


def predict_wkv_gflops(problem: WkvProblem, cfg, device: DeviceModel = H100_SXM5, **kw) -> float:
    t = predict_wkv_time(problem, cfg, device, **kw)
    if not np.isfinite(t) or t <= 0:
        return 0.0
    s, hd = problem
    h = kw.get("heads") or wkv_heads(hd)
    return wkv_flops(s, hd, h) / t / 1e9


def build_wkv_matrix(problems: list[WkvProblem], configs=None, device: DeviceModel | str | None = H100_SXM5,
                     **kw) -> np.ndarray:
    """(n_problems, n_configs) model GFLOP/s: the wkv family's ``model_matrix``."""
    from ..kernels.wkv import config_space

    if not isinstance(device, DeviceModel):
        device = device_model(device)
    configs = list(configs if configs is not None else config_space())
    perf = np.zeros((len(problems), len(configs)))
    for i, p in enumerate(problems):
        for j, c in enumerate(configs):
            perf[i, j] = predict_wkv_gflops(p, c, device, **kw)
    return perf


# ---------------------------------------------------------------------------
# selective scan (csrc/ssm.cu, fused entry)
# ---------------------------------------------------------------------------
def ssm_resident(cfg, n_state: int = SSM_STATE_N, device: DeviceModel = H100_SXM5) -> int:
    """CTAs of the fused entry's output pass one SM holds, by threads and shared
    memory (the model's stand-in for the occupancy query a call makes)."""
    by_threads = SSM_THREADS_PER_SM // cfg.threads()
    by_smem = (228 * 1024) // (cfg.smem_bytes(n_state, True) + 1024)
    return max(1, min(by_threads, by_smem, 32))


def predict_ssm_time(problem: SsmProblem, cfg, device: DeviceModel = H100_SXM5, *,
                     n_state: int = SSM_STATE_N, batch: int = 1) -> float:
    """Predicted seconds of one ``ssm_cuda_fused`` call at (batch, S, d, N); inf
    for a config the card cannot launch."""
    from ..kernels.ssm import GROUP_STEPS, ssm_segments

    s, d = problem
    if cfg.smem_bytes(n_state, True) > device.smem_per_cta:
        return math.inf
    s = max(s, 1)
    resident = ssm_resident(cfg, n_state, device)
    segments = ssm_segments(batch, s, d, cfg, device.sms, resident)
    ctas = batch * _ceil(d, cfg.block_d)
    n_chunks = _ceil(s, cfg.chunk)
    per_cta_chunks = _ceil(n_chunks, segments)
    # A chunk's chain: its 8 steps in every time group at once, then the fold of the groups.
    chunk_s = (GROUP_STEPS + cfg.time_groups()) * SSM_STEP_CYCLES / device.clock_hz
    waves = _ceil(ctas * segments, device.sms * resident)
    t_chain = waves * per_cta_chunks * chunk_s * (2 if segments > 1 else 1)
    # Bytes: x, dt read and y written (d floats a step), b and c (N floats a step) read
    # once per d block (from L2 after the first), the final state written.
    traffic = batch * (s * d * 3 * 4 + s * n_state * 2 * 4 + d * n_state * 4)
    t_mem = traffic / device.hbm_bw
    launches = 2 if segments > 1 else 1
    return max(t_chain, t_mem) + launches * device.launch_overhead


def ssm_flops(s: int, d: int, n_state: int = SSM_STATE_N, batch: int = 1) -> float:
    """The reference's useful FLOPs of one call: 6 s d N."""
    return 6.0 * s * d * n_state * batch


def predict_ssm_gflops(problem: SsmProblem, cfg, device: DeviceModel = H100_SXM5, **kw) -> float:
    t = predict_ssm_time(problem, cfg, device, **kw)
    if not np.isfinite(t) or t <= 0:
        return 0.0
    s, d = problem
    return ssm_flops(s, d, kw.get("n_state", SSM_STATE_N), kw.get("batch", 1)) / t / 1e9


def build_ssm_matrix(problems: list[SsmProblem], configs=None, device: DeviceModel | str | None = H100_SXM5,
                     **kw) -> np.ndarray:
    """(n_problems, n_configs) model GFLOP/s: the ssm_scan family's ``model_matrix``."""
    from ..kernels.ssm import config_space

    if not isinstance(device, DeviceModel):
        device = device_model(device)
    configs = list(configs if configs is not None else config_space())
    perf = np.zeros((len(problems), len(configs)))
    for i, p in enumerate(problems):
        for j, c in enumerate(configs):
            perf[i, j] = predict_ssm_gflops(p, c, device, **kw)
    return perf
