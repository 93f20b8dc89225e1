"""Architecture registry: ``--arch`` lookup, input shapes, GEMM harvest.

The port carries the dense transformer configs, RWKV6 and Hymba so far; the
other families of ``repro.configs`` join when their models are ported.
``ShapeSpec``, ``SHAPES``, ``shapes_for``, ``gemm_problems`` and
``_chunk_widths`` are copied from ``repro/configs/registry.py`` (the tuning
harvest); ``input_specs`` stays behind, it builds JAX shape structs.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig
from .granite_8b import CONFIG as _granite
from .hymba_1_5b import CONFIG as _hymba
from .phi4_mini_3_8b import CONFIG as _phi4
from .rwkv6_7b import CONFIG as _rwkv6

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (_phi4, _granite, _rwkv6, _hymba)}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid run it; the 8 pure
# full-attention archs skip it (documented in DESIGN.md §4).
_SUBQUADRATIC = {"hymba-1.5b", "rwkv6-7b"}


def get(arch: str) -> ArchConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}") from None


def shapes_for(arch: str) -> list[str]:
    cfg = get(arch)
    out = []
    for name in SHAPES:
        if name == "long_500k" and cfg.name not in _SUBQUADRATIC:
            continue
        out.append(name)
    return out


# ---------------------------------------------------------------------------
# GEMM harvesting (tuning-dataset problems; paper §3 'matrix sizes from
# three popular neural networks' — here: from the assigned architectures)
# ---------------------------------------------------------------------------
def gemm_problems(arch: str, shape: str) -> list[tuple[int, int, int, int]]:
    """The (m, k, n, batch) GEMMs this arch launches for this input shape.

    The convention matches what ``repro.kernels.ops.matmul`` featurizes at
    trace time: projections run on un-flattened ``(B, S, D)`` activations, so
    they are recorded as ``(m=S, k, n, batch=B)`` (``m=1`` for decode) — NOT
    flattened to ``(B*S, k, n, 1)``.  Only GEMMs whose call sites genuinely
    flatten (the MoE router on ``(T, d)`` tokens) keep ``batch=1``; per-head
    attention internals and per-expert FFNs keep their own batch counts.
    """
    cfg = get(arch)
    sp = SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len
    m_tok = 1 if sp.kind == "decode" else s  # per-sequence GEMM M at runtime
    tokens = b * m_tok  # flattened token count (router and capacity math)
    d, ff = cfg.d_model, cfg.d_ff
    probs: list[tuple[int, int, int, int]] = []

    def gemm(m, k, n, batch=1):
        probs.append((int(m), int(k), int(n), int(batch)))

    # attention / time-mix projections — launched on (B, S, D) activations
    if cfg.family == "ssm":
        for out in (cfg.q_dim, cfg.q_dim, cfg.q_dim, cfg.q_dim, d):  # r,k,v,g,o
            gemm(m_tok, d, out, b)
    else:
        gemm(m_tok, d, cfg.q_dim, b)  # Q
        gemm(m_tok, d, cfg.kv_dim, b)  # K
        gemm(m_tok, d, cfg.kv_dim, b)  # V
        gemm(m_tok, cfg.q_dim, d, b)  # out proj
        if sp.kind != "decode":
            # score/context GEMMs per head (flash-attn internal shapes)
            hd = cfg.head_dim
            gemm(s, hd, s, b * cfg.n_heads)
            gemm(s, s, hd, b * cfg.n_heads)
    # FFN
    if cfg.moe is not None:
        e, k_ = cfg.moe.n_experts, cfg.moe.top_k
        gemm(tokens, d, e)  # router (moe_ffn flattens to (T, d) before matmul)
        cap_tokens = max(1, (tokens * k_) // e)
        for _ in range(2):
            gemm(cap_tokens, d, ff, e)  # gate/up per expert
        gemm(cap_tokens, ff, d, e)  # down per expert
    else:
        gemm(m_tok, d, ff, b)
        gemm(m_tok, d, ff, b)
        gemm(m_tok, ff, d, b)
    # vocab head — (B, S, D) in train, (B, 1, D) in decode
    if sp.kind != "prefill":
        gemm(m_tok, d, cfg.padded_vocab(), b)
    if cfg.family == "vlm":
        gemm(m_tok, d, cfg.q_dim, b)  # cross-q
        gemm(cfg.n_image_tokens, d, cfg.kv_dim, b)
        gemm(cfg.n_image_tokens, d, cfg.kv_dim, b)
    if cfg.family == "hybrid":
        gemm(m_tok, d, 2 * d, b)  # mamba in-proj
        gemm(m_tok, d, d, b)  # mamba out-proj
    if sp.kind == "prefill":
        # Chunked prefill (repro/serve/engine.py): the serving tier replays
        # the same projections one lane at a time over scheduler-budgeted
        # chunk widths from the geometric bucket ladder, so those GEMMs are
        # harvested on-distribution too — batch=1, m=chunk width.  Train
        # shapes are untouched (the fig7 dataset is train_4k-only).
        for c in _chunk_widths(s):
            if cfg.family == "ssm":
                for out in (cfg.q_dim, cfg.q_dim, cfg.q_dim, cfg.q_dim, d):
                    gemm(c, d, out, 1)
            else:
                gemm(c, d, cfg.q_dim, 1)  # Q
                gemm(c, d, cfg.kv_dim, 1)  # K
                gemm(c, d, cfg.kv_dim, 1)  # V
                gemm(c, cfg.q_dim, d, 1)  # out proj
            if cfg.moe is not None:
                gemm(c, d, cfg.moe.n_experts)  # router on the chunk's tokens
            else:
                gemm(c, d, ff, 1)
                gemm(c, d, ff, 1)
                gemm(c, ff, d, 1)
    return probs


def _chunk_widths(seq_len: int, floor: int = 512) -> list[int]:
    """Chunk widths the serving ladder would use for ``seq_len`` prompts:
    geometric rungs from ``floor`` up to (exclusive) the sequence length."""
    widths, c = [], floor
    while c < seq_len:
        widths.append(c)
        c *= 2
    return widths
