"""Model families, ported from ``repro/models/model.py``.

Same functional surface as the reference's ``TransformerLM``, ``RWKV6LM`` and
``HymbaLM``:

  init(generator) -> params
  init_cache(batch, cache_len) -> cache dict (k/v per token for the
      transformer; the recurrent wkv/x1/x2 state for RWKV6; per layer
      ``{"k", "v", "ssm"}`` for Hymba, its sliding-window layers' k/v a ring)
  prefill(params, batch, cache_len) -> (last-position logits, cache)
  decode_step(params, cache, tokens, positions) -> (logits, cache)

Params keep the reference's tree and layout: (in, out) matrices with a
stacked leading layer axis.  The reference's ``lax.scan`` over layers is a
Python loop over views of the stacked tensors.  MoE, VLM and
encoder-decoder variants wait for later parts of the port.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import layers as L
from . import mamba as M
from . import rwkv as R


def build_model(cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
    if cfg.family == "ssm":
        return RWKV6LM(cfg, dtype, param_dtype, device)
    if cfg.family == "hybrid":
        return HymbaLM(cfg, dtype, param_dtype, device)
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(f"the port serves dense transformers, RWKV6 and Hymba so far, not {cfg.family!r}")
    return TransformerLM(cfg, dtype, param_dtype, device)


def _initializers(model, generator: torch.Generator | None):
    """``normal(shape, scale)`` and ``full(shape, value)`` in the model's param
    dtype on its device.  Normals are drawn from ``generator`` (on its own
    device, seed 0 on the model's device when None), then moved."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return t.mul_(scale).to(device=model.device, dtype=model.param_dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=model.param_dtype, device=model.device)

    return normal, full


def _init_embedding(cfg: ArchConfig, normal) -> dict:
    pv = cfg.padded_vocab()
    emb = {"embed": normal((pv, cfg.d_model), 0.02)}
    if cfg.tie_embeddings:
        emb["embed_t"] = emb["embed"].t().contiguous()
    else:
        emb["unembed"] = normal((cfg.d_model, pv), 0.02)
    return emb


def _layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s params: every stacked tensor of ``blocks`` indexed at ``i``
    (views, no copies)."""
    return {k: _layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def _dense(cfg: ArchConfig, normal):
    """``dense(d_in, d_out)``: a stacked (n_layers, d_in, d_out) matrix at the
    reference's scale (2 / (d_in + d_out))^0.5."""
    return lambda d_in, d_out: normal((cfg.n_layers, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)


def _init_attention(cfg: ArchConfig, normal) -> dict:
    dense = _dense(cfg, normal)
    return {
        "wq": dense(cfg.d_model, cfg.q_dim),
        "wk": dense(cfg.d_model, cfg.kv_dim),
        "wv": dense(cfg.d_model, cfg.kv_dim),
        "wo": dense(cfg.q_dim, cfg.d_model),
    }


def _init_mlp(cfg: ArchConfig, normal) -> dict:
    dense = _dense(cfg, normal)
    return {
        "w_gate": dense(cfg.d_model, cfg.d_ff),
        "w_up": dense(cfg.d_model, cfg.d_ff),
        "w_down": dense(cfg.d_ff, cfg.d_model),
    }


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
        c = self.cfg
        n = c.n_layers
        normal, full = _initializers(self, generator)
        attn = _init_attention(c, normal)
        ffn = _init_mlp(c, normal)
        return {
            "emb": _init_embedding(c, normal),
            "final_norm": full((c.d_model,), 1.0),
            "blocks": {"attn": attn, "ffn": ffn, "ln1": full((n, c.d_model), 1.0),
                       "ln2": full((n, c.d_model), 1.0)},
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
            x = self._block(_layer_params(params["blocks"], i), x, positions, cache=(cache["k"][i], cache["v"][i]))
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
                _layer_params(params["blocks"], i), x, pos2d,
                cache=(cache["k"][i], cache["v"][i]), cache_positions=positions,
            )
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x), cache


class RWKV6LM:
    """RWKV6 "Finch": attention-free, a recurrent (hd, hd) state per head."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = torch.device(device)

    def init(self, generator: torch.Generator | None = None) -> dict:
        """Random weights drawn from ``generator`` at the reference's scales."""
        c = self.cfg
        normal, full = _initializers(self, generator)
        return {
            "emb": _init_embedding(c, normal),
            "final_norm": full((c.d_model,), 1.0),
            "blocks": {
                "rwkv": R.init_rwkv(c, normal, full),
                "ln1": full((c.n_layers, c.d_model), 1.0),
                "ln2": full((c.n_layers, c.d_model), 1.0),
            },
        }

    def _layer(self, blk: dict, x, state):
        """state: (wkv (B, H, hd, hd), x1 (B, d), x2 (B, d))."""
        c = self.cfg
        wkv_state, x1, x2 = state
        xn = L.rms_norm(x, blk["ln1"], c.norm_eps)
        h, (new_wkv, last1) = R.time_mix_layer(blk["rwkv"], xn, c, state=wkv_state, x_prev=x1)
        x = x + h
        xn2 = L.rms_norm(x, blk["ln2"], c.norm_eps)
        h2, last2 = R.channel_mix_layer(blk["rwkv"], xn2, c, x_prev=x2)
        return x + h2, (new_wkv, last1, last2)

    def init_cache(self, b: int, cache_len: int) -> dict:
        """Recurrent state only: nothing grows with ``cache_len``."""
        c = self.cfg
        n, h, hd, d = c.n_layers, c.n_heads, c.head_dim, c.d_model
        return {
            "wkv": torch.zeros((n, b, h, hd, hd), dtype=torch.float32, device=self.device),
            "x1": torch.zeros((n, b, d), dtype=self.dtype, device=self.device),
            "x2": torch.zeros((n, b, d), dtype=self.dtype, device=self.device),
        }

    def _run(self, params: dict, x, cache: dict):
        """All layers; each layer's new state is written into ``cache`` in
        place (the reference returns a new cache)."""
        for i in range(self.cfg.n_layers):
            blk = _layer_params(params["blocks"], i)
            x, new = self._layer(blk, x, (cache["wkv"][i], cache["x1"][i], cache["x2"][i]))
            for key, t in zip(("wkv", "x1", "x2"), new):
                cache[key][i].copy_(t)
        return x

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Run the prompt ``batch["tokens"]`` (B, S) from a zero state; returns
        the f32 logits of the last position (B, 1, V_padded) and the state."""
        c = self.cfg
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], cache_len)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        x = self._run(params, x, cache)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x[:, -1:]), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens: (B, 1).  ``positions`` is unused: the recurrent state carries
        all history.  The cache is updated in place and returned."""
        del positions
        c = self.cfg
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        x = self._run(params, x, cache)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x), cache


class HymbaLM:
    """Hymba: attention and Mamba heads in parallel on the same normalized
    input, fused as ``x + 0.5 (h_attn + h_mamba)``.  Sliding-window attention
    on every layer but three global ones (first, middle, last)."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = torch.device(device)

    def _layer_kinds(self) -> list[str]:
        n = self.cfg.n_layers
        glob = {0, n // 2, n - 1}
        return ["global" if i in glob else "swa" for i in range(n)]

    def init(self, generator: torch.Generator | None = None) -> dict:
        """Random weights drawn from ``generator`` at the reference's scales."""
        c = self.cfg
        normal, full = _initializers(self, generator)
        return {
            "emb": _init_embedding(c, normal),
            "final_norm": full((c.d_model,), 1.0),
            "blocks": {
                "attn": _init_attention(c, normal),
                "mamba": M.init_mamba(c, normal, full),
                "ffn": _init_mlp(c, normal),
                "ln1": full((c.n_layers, c.d_model), 1.0),
                "ln2": full((c.n_layers, c.d_model), 1.0),
            },
        }

    def _layer(self, blk: dict, x, positions, kind: str, entry: dict, *, cache_positions=None, cache_valid=None):
        """One layer over ``entry`` = this layer's {"k", "v", "ssm"} cache: k/v
        are written in place; returns (x, the new ssm state)."""
        c = self.cfg
        xn = L.rms_norm(x, blk["ln1"], c.norm_eps)
        h_attn = L.attention_layer(
            blk["attn"], xn, c, positions, cache=(entry["k"], entry["v"]),
            cache_positions=cache_positions, cache_valid=cache_valid,
            window=0 if kind == "global" else c.window,
        )
        if x.shape[1] == 1:
            h_mamba, ssm = M.mamba_decode_step(blk["mamba"], xn, entry["ssm"], c)
        else:
            h_mamba, ssm = M.mamba_layer(blk["mamba"], xn, c)
        x = x + 0.5 * (h_attn + h_mamba)
        return x + L.mlp_layer(blk["ffn"], L.rms_norm(x, blk["ln2"], c.norm_eps)), ssm

    def init_cache(self, b: int, cache_len: int) -> dict:
        """Per layer: k/v of ``cache_len`` tokens on global layers and a ring of
        ``min(window, cache_len)`` on sliding-window ones, and the (B, d, N)
        f32 SSM state."""
        c = self.cfg
        cache = {}
        for i, kind in enumerate(self._layer_kinds()):
            t = cache_len if kind == "global" else min(c.window, cache_len)
            kv = (b, t, c.n_kv_heads, c.head_dim)
            cache[f"layer{i}"] = {
                "k": torch.zeros(kv, dtype=self.dtype, device=self.device),
                "v": torch.zeros(kv, dtype=self.dtype, device=self.device),
                "ssm": torch.zeros((b, c.d_model, c.ssm_state), dtype=torch.float32, device=self.device),
            }
        return cache

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Run the prompt ``batch["tokens"]`` (B, S); returns the f32 logits
        of the last position (B, 1, V_padded) and the filled cache."""
        c = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len)
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        for i, kind in enumerate(self._layer_kinds()):
            entry = cache[f"layer{i}"]
            x, entry["ssm"] = self._layer(_layer_params(params["blocks"], i), x, positions, kind, entry)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x[:, -1:]), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens: (B, 1); positions: (B,) — index of the new token.  Sliding-
        window layers write ring slot ``positions % T`` and attend over
        ``min(positions + 1, T)`` slots.  The cache is updated in place and
        returned."""
        c = self.cfg
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        pos2d = positions[:, None]
        for i, kind in enumerate(self._layer_kinds()):
            entry = cache[f"layer{i}"]
            t = entry["k"].shape[1]
            if kind == "global":
                cpos, cvalid = positions, positions + 1
            else:
                cpos, cvalid = positions % t, torch.clamp(positions + 1, max=t)
            x, ssm = self._layer(_layer_params(params["blocks"], i), x, pos2d, kind, entry,
                                 cache_positions=cpos, cache_valid=cvalid)
            entry["ssm"].copy_(ssm)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x), cache
