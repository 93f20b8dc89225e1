"""The attention family's problem space: features, the harvest, an H100 model.

The counterpart of ``repro/core/attnmodel.py``: the problem is ``(sq, skv,
d)`` (query rows, key/value rows, head dim) and the config
``AttentionConfig(block_q, block_kv)``.  The family's table is measured on
the card (``core/gpubench.py``); :func:`build_attn_matrix` is its
``model_matrix``, the model side the staged pipeline prunes and fills with.
It follows ``csrc/attention.cu`` at the leading dims the table is timed at
(1, 32 heads), bf16, under the causal mask:

  * ceil(sq / block_q) x heads CTAs, times the KV splits
    ``kernels/attention.py::kv_splits`` gives them, in waves over the SMs;
    the CTAs an SM holds from the shared memory of the TMA ring;
  * ``wgmma`` consumers at block_q 64 and 128, ``mma.sync`` at 32, each at
    its share of the tensor-core peak (``perfmodel.MMA_EFFICIENCY``), over
    the live KV blocks only (causal blocks past the diagonal are skipped);
  * each CTA walks its KV blocks in a chain, one block a step;
  * bytes: Q and O once, K and V once per head where every head's K/V fits
    in the L2, else again per band of 8 query blocks; a split call's f32
    partials written and read back.

The step latency is a model assumption, not a measurement.
"""
from __future__ import annotations

import math

import numpy as np

from .perfmodel import BAND, H100_SXM5, MMA_EFFICIENCY, SM_SMEM, DeviceModel, device_model

AttnProblem = tuple[int, int, int]  # (sq, skv, head_dim)

ATTN_FEATURE_NAMES = ("log2_sq", "log2_skv", "log2_d", "log2_sq_over_skv")


def attn_problem_features(problems: list[AttnProblem]) -> np.ndarray:
    p = np.asarray(problems, dtype=np.float64).reshape(-1, 3)
    if p.size == 0:
        return np.zeros((0, len(ATTN_FEATURE_NAMES)))
    sq, skv, d = p.T
    return np.column_stack([np.log2(sq), np.log2(skv), np.log2(d), np.log2(sq / skv)])


def harvest_attn_problems(arch_ids: list[str] | None = None) -> list[AttnProblem]:
    """Attention shapes the assigned architectures actually launch."""
    from ..configs import registry

    arch_ids = arch_ids or list(registry.ARCHS)
    out: set[AttnProblem] = set()
    for arch in arch_ids:
        cfg = registry.get(arch)
        if cfg.family == "ssm":
            continue  # attention-free (DESIGN.md §4)
        hd = cfg.head_dim
        for shape in registry.shapes_for(arch):
            sp = registry.SHAPES[shape]
            if sp.kind == "decode":
                out.add((1, sp.seq_len, hd))
            else:
                out.add((sp.seq_len, sp.seq_len, hd))
                # chunked-prefill style sub-blocks
                out.add((min(2048, sp.seq_len), sp.seq_len, hd))
    return sorted(out)


ATTN_MODEL_HEADS = 32  # the leading dims gpubench times a problem at: (1, 32)
ATTN_STEP_CYCLES = 500  # model assumption: one KV block of a CTA's chain (barrier, MMAs, softmax)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def predict_attn_time(problem: AttnProblem, cfg, device: DeviceModel = H100_SXM5, *,
                      heads: int = ATTN_MODEL_HEADS, causal: bool = True) -> float:
    """Predicted seconds of one bf16 ``attention_cuda`` call at (1, heads); inf for
    a config the card cannot launch."""
    from ..kernels.attention import kv_blocks, kv_splits

    sq, skv, d = problem
    path = cfg.bf16_path()
    smem = cfg.smem_bytes(d, path)
    if smem > device.smem_per_cta:
        return math.inf
    resident = max(1, min(SM_SMEM // (smem + 1024), 2048 // cfg.threads(path)))
    splits = kv_splits(heads, sq, skv, cfg, causal, device.sms, d, resident)
    n_q = _ceil(sq, cfg.block_q)
    live = sum(kv_blocks(q0, sq, skv, cfg, causal) for q0 in range(0, sq, cfg.block_q))
    most = max((kv_blocks(q0, sq, skv, cfg, causal) for q0 in range(0, sq, cfg.block_q)), default=0)
    ctas = n_q * heads * splits
    slots = device.sms * resident
    waves = _ceil(ctas, slots)
    flops = 4.0 * live * heads * cfg.block_q * cfg.block_kv * d
    util = min(1.0, ctas / slots)
    t_compute = flops / (device.peak_flops * MMA_EFFICIENCY[path] * util)
    t_chain = waves * _ceil(most, splits) * ATTN_STEP_CYCLES / device.clock_hz
    kv_bytes = 2.0 * skv * d * 2
    reread = 1 if kv_bytes * min(heads, slots) <= device.l2_bytes else _ceil(n_q, BAND)
    traffic = heads * (2.0 * sq * d * 2 + reread * kv_bytes)
    if splits > 1:
        traffic += 2.0 * ctas * cfg.block_q * (d + 2) * 4
    t_mem = traffic / device.hbm_bw
    return max(t_compute, t_chain, t_mem) + waves * device.wave_overhead + device.launch_overhead


def predict_attn_gflops(problem: AttnProblem, cfg, device: DeviceModel = H100_SXM5, *,
                        heads: int = ATTN_MODEL_HEADS, causal: bool = True) -> float:
    """Useful GFLOP/s, counted as the table counts them (gpubench.attention_flops)."""
    t = predict_attn_time(problem, cfg, device, heads=heads, causal=causal)
    if not np.isfinite(t) or t <= 0:
        return 0.0
    sq, skv, d = problem
    return 4.0 * sq * skv * d * heads * (0.5 if causal and sq == skv else 1.0) / t / 1e9


def build_attn_matrix(problems: list[AttnProblem], configs=None, device: DeviceModel | str | None = H100_SXM5,
                      **kw) -> np.ndarray:
    """(n_problems, n_configs) model GFLOP/s: the attention family's ``model_matrix``."""
    from ..kernels.attention import config_space

    if not isinstance(device, DeviceModel):
        device = device_model(device)
    configs = list(configs if configs is not None else config_space())
    perf = np.zeros((len(problems), len(configs)))
    for i, p in enumerate(problems):
        for j, c in enumerate(configs):
            perf[i, j] = predict_attn_gflops(p, c, device, **kw)
    return perf
