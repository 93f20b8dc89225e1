"""Architecture config schema shared by all assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One selectable ``--arch`` configuration.

    ``family`` picks the model implementation:
      'dense'  — decoder-only transformer (GQA, RoPE, SwiGLU)
      'moe'    — dense backbone with MoE FFN every layer
      'vlm'    — dense backbone with cross-attention layers every
                 ``cross_every``-th layer over stubbed image embeddings
      'hybrid' — parallel attention + Mamba(SSM) heads per layer (Hymba)
      'audio'  — encoder-decoder (Seamless backbone; stubbed frame embeddings)
      'ssm'    — RWKV6 (attention-free)
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    moe: MoESpec | None = None
    qkv_bias: bool = False  # qwen2.5
    cross_every: int = 0  # vlm: 1 cross-attn layer per this many layers
    n_image_tokens: int = 1024  # vlm stub frontend
    ssm_state: int = 0  # hybrid: mamba state size
    window: int = 0  # hybrid: sliding-window size for SWA layers
    n_enc_layers: int = 0  # audio: encoder depth (decoder uses n_layers)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""  # provenance note ([arXiv/hf; tier])

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def padded_vocab(self, multiple: int = 128) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "ssm":
            attn = 6 * d * d  # rwkv time-mix r/k/v/g/o + decay
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * ff
        block = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = self.n_enc_layers * block if self.family == "audio" else 0
        return L * block + enc + emb

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn = self.moe.top_k * 3 * d * ff + d * self.moe.n_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small_moe = None
        if self.moe is not None:
            small_moe = MoESpec(n_experts=min(self.moe.n_experts, 4), top_k=min(self.moe.top_k, 2))
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab=256,
            moe=small_moe,
            n_image_tokens=16,
            cross_every=2 if self.cross_every else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            window=32 if self.window else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
        )
