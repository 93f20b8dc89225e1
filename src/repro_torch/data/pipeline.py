"""Deterministic, step-indexed synthetic token pipeline, ported from
``repro/data/pipeline.py``.

Batch ``i`` is a pure function of ``(seed, step, host_index)``: there is no
iterator state to checkpoint, so exact resume after preemption is "continue
from step N" and an elastic resize re-derives each host's shard
(:func:`reshard`).  Tokens come from a seeded order-1 Markov chain over the
vocab (not iid-uniform), so the LM loss falls.  The numpy code is the
reference's, copied: the same seed gives the same batches, token for token.

The reference casts a VLM's ``image_embs`` and an encoder-decoder's
``frames`` to bf16 with ml_dtypes' ``astype(jnp.bfloat16)``; the port draws
the same f32 values and rounds them with ``Tensor.to(torch.bfloat16)``.  Both
round to nearest, ties to even, so the bf16 bits are equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    host_index: int = 0
    host_count: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError(f"global_batch {self.global_batch} is not divisible by {self.host_count} hosts")
        return self.global_batch // self.host_count


def _fold(*parts: int) -> np.random.Generator:
    """Deterministic RNG from structural coordinates (no global state)."""
    return np.random.default_rng(np.array(parts, dtype=np.uint64))


class MarkovChain:
    """Order-1 seeded Markov chain with a low-rank transition structure: each
    token maps to one of ``n_groups`` regimes, each regime strongly prefers
    ``peak`` successor tokens."""

    def __init__(self, vocab: int, seed: int, n_groups: int = 64, peak: int = 8):
        self.vocab = vocab
        rng = _fold(seed, 0xC0FFEE)
        self.n_groups = min(n_groups, vocab)
        self.group_of = rng.integers(0, self.n_groups, size=vocab)
        self.peaks = rng.integers(0, vocab, size=(self.n_groups, peak))

    def sample(self, rng: np.random.Generator, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), dtype=np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        # 85%: one of the group's peak tokens; 15%: uniform exploration.
        peak_choice = rng.integers(0, self.peaks.shape[1], size=(batch, seq_len))
        uniform = rng.integers(0, self.vocab, size=(batch, seq_len))
        explore = rng.random((batch, seq_len)) < 0.15
        for t in range(1, seq_len):
            g = self.group_of[out[:, t - 1]]
            nxt = self.peaks[g, peak_choice[:, t]]
            out[:, t] = np.where(explore[:, t], uniform[:, t], nxt)
        return out


class TokenPipeline:
    """``batch(step)`` -> host-local training batch for one architecture."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self.chain = MarkovChain(cfg.vocab, data.seed)

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        """CPU tensors: ``tokens`` / ``targets`` (B, S) int64 (the next-token
        shift of one S + 1 draw), and for a VLM ``image_embs`` (B,
        n_image_tokens, d) or for an encoder-decoder ``frames`` (B, S, d),
        both bf16."""
        d = self.data
        rng = _fold(d.seed, step, d.host_index)
        b, s = d.local_batch, d.seq_len
        toks = torch.from_numpy(self.chain.sample(rng, b, s + 1)).long()
        out = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
        if self.cfg.family == "vlm":
            draw = rng.standard_normal((b, self.cfg.n_image_tokens, self.cfg.d_model), dtype=np.float32)
            out["image_embs"] = torch.from_numpy(draw).to(torch.bfloat16)
        elif self.cfg.family == "audio":
            draw = rng.standard_normal((b, s, self.cfg.d_model), dtype=np.float32)
            out["frames"] = torch.from_numpy(draw).to(torch.bfloat16)
        return out

    def device_batch(self, step: int, dtype=torch.float32, device="cuda") -> dict[str, torch.Tensor]:
        """:meth:`batch` on ``device``: f32 leaves cast to ``dtype``; the bf16
        leaves stay bf16 and the token ids int64, as the reference's."""
        return {k: (v.to(dtype) if v.dtype == torch.float32 else v).to(device) for k, v in self.batch(step).items()}


def reshard(data: DataConfig, host_index: int, host_count: int) -> DataConfig:
    """Elastic resize: same stream, new topology (stateless => trivial)."""
    return dataclasses.replace(data, host_index=host_index, host_count=host_count)
