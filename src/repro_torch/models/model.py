"""Dense decoder-only transformer, ported from ``repro/models/model.py``.

Same functional surface as the reference's ``TransformerLM``:

  init(generator) -> params
  init_cache(batch, cache_len) -> {"k", "v"} of shape (n_layers, B, T, KV, hd)
  prefill(params, batch, cache_len) -> (last-position logits, cache)
  decode_step(params, cache, tokens, positions) -> (logits, cache)

Params keep the reference's tree and layout: (in, out) matrices with a
stacked leading layer axis.  The reference's ``lax.scan`` over layers is a
Python loop over views of the stacked tensors.  MoE and VLM variants wait for
later parts of the port.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import layers as L


def build_model(cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(f"the port serves dense transformers so far, not {cfg.family!r}")
    return TransformerLM(cfg, dtype, param_dtype, device)


_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")


class TransformerLM:
    """Dense decoder-only LM (GQA, RoPE, SwiGLU)."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = torch.device(device)

    # -- params -----------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> dict:
        """Random weights drawn from ``generator`` (on its own device), then
        moved to the model's device.  Scales follow the reference's
        initializers; the numbers themselves differ (another generator)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        c = self.cfg
        n = c.n_layers
        pv = c.padded_vocab()

        def normal(shape, scale):
            t = torch.randn(shape, generator=generator, device=generator.device)
            return t.mul_(scale).to(device=self.device, dtype=self.param_dtype)

        def dense(d_in, d_out):
            return normal((n, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)

        def ones(*shape):
            return torch.ones(shape, dtype=self.param_dtype, device=self.device)

        attn = {
            "wq": dense(c.d_model, c.q_dim),
            "wk": dense(c.d_model, c.kv_dim),
            "wv": dense(c.d_model, c.kv_dim),
            "wo": dense(c.q_dim, c.d_model),
        }
        ffn = {
            "w_gate": dense(c.d_model, c.d_ff),
            "w_up": dense(c.d_model, c.d_ff),
            "w_down": dense(c.d_ff, c.d_model),
        }
        emb = {"embed": normal((pv, c.d_model), 0.02)}
        if c.tie_embeddings:
            emb["embed_t"] = emb["embed"].t().contiguous()
        else:
            emb["unembed"] = normal((c.d_model, pv), 0.02)
        return {
            "emb": emb,
            "final_norm": ones(c.d_model),
            "blocks": {"attn": attn, "ffn": ffn, "ln1": ones(n, c.d_model), "ln2": ones(n, c.d_model)},
        }

    @staticmethod
    def _layer(params: dict, i: int) -> dict:
        blocks = params["blocks"]
        return {
            "attn": {k: blocks["attn"][k][i] for k in _ATTN},
            "ffn": {k: blocks["ffn"][k][i] for k in _FFN},
            "ln1": blocks["ln1"][i],
            "ln2": blocks["ln2"][i],
        }

    # -- one transformer block ----------------------------------------------
    def _block(self, blk: dict, x, positions, *, cache, cache_positions=None):
        c = self.cfg
        x = x + L.attention_layer(
            blk["attn"], L.rms_norm(x, blk["ln1"], c.norm_eps), c, positions,
            cache=cache, cache_positions=cache_positions,
        )
        return x + L.mlp_layer(blk["ffn"], L.rms_norm(x, blk["ln2"], c.norm_eps))

    # -- caches / serving ---------------------------------------------------
    def init_cache(self, b: int, cache_len: int) -> dict:
        c = self.cfg
        shape = (c.n_layers, b, cache_len, c.n_kv_heads, c.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
        }

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Run the prompt ``batch["tokens"]`` (B, S); returns the f32 logits
        of the last position (B, 1, V_padded) and the filled cache."""
        c = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len)
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        for i in range(c.n_layers):
            x = self._block(self._layer(params, i), x, positions, cache=(cache["k"][i], cache["v"][i]))
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x[:, -1:]), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens: (B, 1); positions: (B,) — index of the new token.  The
        cache is updated in place and returned."""
        c = self.cfg
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        pos2d = positions[:, None]
        for i in range(c.n_layers):
            x = self._block(
                self._layer(params, i), x, pos2d,
                cache=(cache["k"][i], cache["v"][i]), cache_positions=positions,
            )
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x), cache
