"""Model families, ported from ``repro/models/model.py``.

Same functional surface as the reference's ``TransformerLM`` (dense, MoE
FFN, QKV bias, interleaved image cross-attention), ``RWKV6LM``, ``HymbaLM``
and ``EncDecLM`` (the encoder-decoder, seamless):

  init(generator) -> params
  loss_fn(params, batch) -> (scalar loss, metrics)   [train shapes; every
      layer body checkpointed with the policy of ``layers.set_remat_policy``]
  init_cache(batch, cache_len) -> cache dict (k/v per token for the
      transformer, int8 with f32 scales under ``kv_quant``, and a VLM's
      per-group ``cross_k`` / ``cross_v`` over the image tokens; the recurrent
      wkv/x1/x2 state for RWKV6; per layer ``{"k", "v", "ssm"}`` for Hymba,
      its sliding-window layers' k/v a ring)
  prefill(params, batch, cache_len) -> (last-position logits, cache)
      (a VLM's batch also holds ``image_embs`` (B, n_image_tokens, d))
  decode_step(params, cache, tokens, positions) -> (logits, cache)
  prefill_chunk(params, cache, tokens, start, last_row) -> (logits, cache)
      (the transformer only, not a VLM or an int8 cache: chunked prefill, as
      in the reference)

An encoder-decoder's batch holds ``frames`` (B, S, d), the stubbed audio
frontend's embeddings; its ``prefill`` adds the encoder output as a
``memory`` leaf that ``init_cache`` lacks, as the reference's does, so the
serving engine serves it in neither package.

Params keep the reference's tree and layout: (in, out) matrices with a
stacked leading layer axis.  The reference's ``lax.scan`` over layers is a
Python loop over views of the stacked tensors, through ``ops.scan_layers``
for the transformer and RWKV6 (whose reference scans): their kernel
selections run for layer 0 and later layers reuse them, as a scan traces its
body once.  A VLM scans its groups and, inside each, its self-attention
layers, as the reference nests its scans.  Hymba loops over its layers in
both packages, except in ``loss_fn``, where its reference scans too.  The
encoder-decoder scans its encoder and decoder stacks.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L
from . import mamba as M
from . import moe as MOE
from . import rwkv as R


def build_model(cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda",
                kv_quant: bool = False):
    """The model of ``cfg``'s family on ``device``.  ``kv_quant`` gives a
    transformer (dense, MoE or VLM) an int8 KV cache (the reference's
    ``build_model(kv_quant=)``; other families ignore it, as there)."""
    if cfg.family == "ssm":
        return RWKV6LM(cfg, dtype, param_dtype, device)
    if cfg.family == "hybrid":
        return HymbaLM(cfg, dtype, param_dtype, device)
    if cfg.family == "audio":
        return EncDecLM(cfg, dtype, param_dtype, device)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    model = TransformerLM(cfg, dtype, param_dtype, device)
    model.kv_quant = kv_quant
    return model


_AUX_COEF = 0.01  # the MoE load-balance loss's weight in the total, as the reference's


def _loss(params: dict, x: torch.Tensor, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Final norm, f32 logits over the padded vocab, mean token NLL."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.cross_entropy_loss(L.logits_from_hidden(params["emb"], x), batch["targets"].to(x.device), cfg.vocab)


# Every weight is drawn in pieces of _DRAW_ELEMS f32 values, each scaled and cast into
# the preallocated parameter as it lands: drawn whole in f32, qwen2.5-32b's stacked w_gate
# alone would be a 36 GB transient beside its 65.5 GB of bf16 weights.
_DRAW_ELEMS = 1 << 26


def _initializers(model, generator: torch.Generator | None):
    """``normal(shape, scale)`` and ``full(shape, value)`` in the model's param
    dtype on its device.  Normals are drawn from ``generator`` (on its own
    device, seed 0 on the model's device when None) in pieces of
    ``_DRAW_ELEMS`` in order, each scaled and cast into the preallocated
    parameter.  On the meta device (the dry run) nothing is drawn: the
    params are shapes only."""
    if model.device.type == "meta":
        empty = lambda shape, _: torch.empty(shape, dtype=model.param_dtype, device="meta")
        return empty, empty
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)

    def normal(shape, scale):
        out = torch.empty(shape, dtype=model.param_dtype, device=model.device)
        flat = out.view(-1)
        for i in range(0, flat.numel(), _DRAW_ELEMS):
            n = min(_DRAW_ELEMS, flat.numel() - i)
            piece = torch.randn(n, generator=generator, device=generator.device).mul_(scale)
            flat[i:i + n].copy_(piece)
        return out

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


def _placed_like(cache: dict, params: dict) -> dict:
    """A prefill's fresh cache, placed by ``cache_pspecs`` on the params' mesh
    where the params are DTensors (the reference's prefill returns its cache
    with those shardings); as it is otherwise."""
    from torch.distributed.tensor import DTensor

    from ..dist import sharding as shd

    embed = params["emb"]["embed"]
    if not isinstance(embed, DTensor):
        return cache
    return shd.distribute_tree(cache, shd.cache_pspecs(cache, embed.device_mesh), embed.device_mesh)


def _layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s params: every stacked tensor of ``blocks`` indexed at ``i``
    (views, no copies)."""
    return {k: _layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


def _dense(n: int, normal):
    """``dense(d_in, d_out)``: a stacked (n, d_in, d_out) matrix at the
    reference's scale (2 / (d_in + d_out))^0.5."""
    return lambda d_in, d_out: normal((n, d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5)


def _init_attention(cfg: ArchConfig, normal, full, n_layers: int | None = None) -> dict:
    """Stacked Q/K/V/O projections; with ``cfg.qkv_bias`` also zero ``bq`` /
    ``bk`` / ``bv``, as the reference initialises them."""
    n = cfg.n_layers if n_layers is None else n_layers
    dense = _dense(n, normal)
    p = {
        "wq": dense(cfg.d_model, cfg.q_dim),
        "wk": dense(cfg.d_model, cfg.kv_dim),
        "wv": dense(cfg.d_model, cfg.kv_dim),
        "wo": dense(cfg.q_dim, cfg.d_model),
    }
    if cfg.qkv_bias:
        p["bq"] = full((n, cfg.q_dim), 0.0)
        p["bk"] = full((n, cfg.kv_dim), 0.0)
        p["bv"] = full((n, cfg.kv_dim), 0.0)
    return p


def _init_mlp(cfg: ArchConfig, normal, n_layers: int | None = None) -> dict:
    dense = _dense(cfg.n_layers if n_layers is None else n_layers, normal)
    return {
        "w_gate": dense(cfg.d_model, cfg.d_ff),
        "w_up": dense(cfg.d_model, cfg.d_ff),
        "w_down": dense(cfg.d_ff, cfg.d_model),
    }


class TransformerLM:
    """Decoder-only LM (GQA, RoPE, SwiGLU): an MoE FFN when ``cfg.moe``, QKV
    biases when ``cfg.qkv_bias``, and for a VLM a cross-attention block over
    the image embeddings closing every group of ``cross_every`` layers."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = torch.device(device)
        self.kv_quant = False  # int8 KV cache (set through build_model)
        self.is_moe = cfg.moe is not None
        self.is_vlm = cfg.family == "vlm"
        if self.is_vlm:
            if cfg.n_layers % cfg.cross_every:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of cross_every "
                                 f"{cfg.cross_every}")
            self.n_groups = cfg.n_layers // cfg.cross_every
            self.self_per_group = cfg.cross_every - 1  # the last layer of a group is the cross block
        if self.is_moe and self.is_vlm:
            raise ValueError("an MoE FFN does not combine with a VLM, as in the reference")

    @property
    def n_self(self) -> int:
        """Self-attention layers: all of them, or ``n_groups * (cross_every - 1)`` for a VLM."""
        return self.n_groups * self.self_per_group if self.is_vlm else self.cfg.n_layers

    # -- params -----------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> dict:
        """Random weights drawn from ``generator`` (on its own device), then
        moved to the model's device.  Scales follow the reference's
        initializers; the numbers themselves differ (another generator)."""
        c = self.cfg
        n = self.n_self
        normal, full = _initializers(self, generator)
        blocks = {"attn": _init_attention(c, normal, full, n), "ln1": full((n, c.d_model), 1.0),
                  "ln2": full((n, c.d_model), 1.0)}
        if self.is_moe:
            blocks["moe"] = MOE.init_moe(c, normal, n)
        else:
            blocks["ffn"] = _init_mlp(c, normal, n)
        params = {"emb": _init_embedding(c, normal), "final_norm": full((c.d_model,), 1.0), "blocks": blocks}
        if self.is_vlm:
            g = self.n_groups
            params["cross"] = {
                "attn": _init_attention(c, normal, full, g),
                "ffn": _init_mlp(c, normal, g),
                "ln1": full((g, c.d_model), 1.0),
                "ln2": full((g, c.d_model), 1.0),
                "ln_img": full((g, c.d_model), 1.0),
            }
        return params

    # -- blocks -------------------------------------------------------------
    def _self_block(self, blk: dict, x, positions, *, cache, cache_positions=None, chunk_start=None):
        """Self-attention and the FFN (dense or MoE); returns (x, aux loss)."""
        c = self.cfg
        x = x + L.attention_layer(
            blk["attn"], L.rms_norm(x, blk["ln1"], c.norm_eps), c, positions,
            cache=cache, cache_positions=cache_positions, chunk_start=chunk_start,
        )
        xn = L.rms_norm(x, blk["ln2"], c.norm_eps)
        if self.is_moe:
            out, aux = MOE.moe_ffn(blk["moe"], xn, c)
        else:
            out, aux = L.mlp_layer(blk["ffn"], xn), 0.0
        return L.shard_act(x + out), aux

    def _cross_block(self, blk: dict, x, image_embs):
        """Cross-attention over the normalised image embeddings (no rope, no
        mask), then the group's FFN."""
        c = self.cfg
        x = x + L.attention_layer(
            blk["attn"], L.rms_norm(x, blk["ln1"], c.norm_eps), c, None,
            kv_input=L.rms_norm(image_embs, blk["ln_img"], c.norm_eps),
        )
        return L.shard_act(x + L.mlp_layer(blk["ffn"], L.rms_norm(x, blk["ln2"], c.norm_eps)))

    def _forward(self, params: dict, tokens: torch.Tensor, *, image_embs=None, remat: bool = False):
        """The training forward over the stack, no cache: (hidden after the
        final layer (B, S, d), f32 MoE aux loss summed over layers).  With
        ``remat`` each self layer is checkpointed, and for a VLM each group
        as well (nested), as the reference's ``jax.checkpoint``-ed scans."""
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = L.embed_tokens(params["emb"], tokens.to(self.device)).to(self.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)

        def self_body(x, aux, blk):
            x, aux_i = self._self_block(blk, x, positions, cache=None)
            return x, aux + aux_i

        body = L.ckpt(self_body) if remat else self_body
        blocks = params["blocks"]
        if not self.is_vlm:
            for i in ops.scan_layers(self.cfg.n_layers):
                x, aux = body(x, aux, _layer_params(blocks, i))
            return x, aux
        spg = self.self_per_group

        def group_body(x, aux, g):
            for j in ops.scan_layers(spg):
                x, aux = body(x, aux, _layer_params(blocks, g * spg + j))
            return self._cross_block(_layer_params(params["cross"], g), x, image_embs.to(self.device)), aux

        gbody = L.ckpt(group_body) if remat else group_body
        for g in ops.scan_layers(self.n_groups):
            x, aux = gbody(x, aux, g)
        return x, aux

    def loss_fn(self, params: dict, batch: dict):
        """Mean token NLL of ``batch["targets"]`` (plus 0.01 x the MoE
        load-balance loss for an MoE); a VLM reads ``batch["image_embs"]``.
        Returns (loss, {"ce_loss", "aux_loss"})."""
        x, aux = self._forward(params, batch["tokens"], image_embs=batch.get("image_embs"), remat=True)
        loss = _loss(params, x, self.cfg, batch)
        total = loss + _AUX_COEF * aux if self.is_moe else loss
        return total, {"ce_loss": loss, "aux_loss": aux}

    def _self_layers(self, params: dict, x, positions, cache: dict, after_group=None, **kw):
        """Every self-attention layer over ``x``, each writing its cache rows in
        place: one scan over the stack, or, for a VLM, a scan over the groups
        with a scan over each group's self layers inside, then
        ``after_group(g, cross_params, x) -> x``.  Selection follows the
        reference's scans: layer 0 of the (first group's) stack selects and
        later layers replay."""
        blocks = params["blocks"]
        if not self.is_vlm:
            for i in ops.scan_layers(self.cfg.n_layers):
                x, _ = self._self_block(_layer_params(blocks, i), x, positions, cache=self._layer_cache(cache, i),
                                        **kw)
            return x
        spg = self.self_per_group
        for g in ops.scan_layers(self.n_groups):
            for j in ops.scan_layers(spg):
                i = g * spg + j
                x, _ = self._self_block(_layer_params(blocks, i), x, positions, cache=self._layer_cache(cache, i),
                                        **kw)
            x = after_group(g, _layer_params(params["cross"], g), x)
        return x

    # -- caches / serving ---------------------------------------------------
    def init_cache(self, b: int, cache_len: int) -> dict:
        """k/v per token, (n_self, B, T, KV, hd); an int8 cache holds them
        as int8 with (n_self, B, T, KV) f32 ``k_scale`` / ``v_scale``.  A VLM
        adds ``cross_k`` / ``cross_v`` (n_groups, B, n_image_tokens, KV, hd)
        in the activation dtype."""
        c = self.cfg
        shape = (self.n_self, b, cache_len, c.n_kv_heads, c.head_dim)
        if self.kv_quant:
            cache = {
                "k": torch.zeros(shape, dtype=torch.int8, device=self.device),
                "v": torch.zeros(shape, dtype=torch.int8, device=self.device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=self.device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=self.device),
            }
        else:
            cache = {
                "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            }
        if self.is_vlm:
            cross = (self.n_groups, b, c.n_image_tokens, c.n_kv_heads, c.head_dim)
            cache["cross_k"] = torch.zeros(cross, dtype=self.dtype, device=self.device)
            cache["cross_v"] = torch.zeros(cross, dtype=self.dtype, device=self.device)
        return cache

    @property
    def _cache_keys(self) -> tuple[str, ...]:
        return ("k", "v", "k_scale", "v_scale") if self.kv_quant else ("k", "v")

    def _layer_cache(self, cache: dict, i: int) -> tuple:
        return tuple(cache[key][i] for key in self._cache_keys)

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Run the prompt ``batch["tokens"]`` (B, S); returns the f32 logits
        of the last position (B, 1, V_padded) and the filled cache.  A VLM
        reads ``batch["image_embs"]`` (B, n_image_tokens, d) and writes each
        group's cross K/V once, for the decode steps to attend over."""
        c = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = _placed_like(self.init_cache(b, cache_len), params)
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        after_group = None
        if self.is_vlm:
            image_embs = batch["image_embs"].to(device=self.device, dtype=self.dtype)
            kvh, hd = c.n_kv_heads, c.head_dim

            def after_group(g, cross, x):
                x = self._cross_block(cross, x, image_embs)
                # Cross K/V are static per request: computed once here.
                imn = L.rms_norm(image_embs, cross["ln_img"], c.norm_eps)
                cache["cross_k"][g] = L.split(ops.matmul(imn, cross["attn"]["wk"]), b, imn.shape[1], kvh, hd)
                cache["cross_v"][g] = L.split(ops.matmul(imn, cross["attn"]["wv"]), b, imn.shape[1], kvh, hd)
                return x

        x = self._self_layers(params, x, positions, cache, after_group)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x[:, -1:]), cache

    def supports_chunked_prefill(self) -> bool:
        """Chunk-append prefill works on the plain k/v layout (dense or MoE); a
        VLM and an int8 cache fall back to monolithic prefill, as in the
        reference."""
        return not self.is_vlm and not self.kv_quant

    def prefill_chunk(self, params: dict, cache: dict, tokens: torch.Tensor, start, last_row=None):
        """Append a prompt chunk at absolute positions ``[start, start + S)``.

        ``tokens``: (B, S); ``start`` and ``last_row`` (default ``S - 1``,
        the row whose logits are returned: a padded final chunk asks for its
        last real row) are 0-d tensors or ints.  Nothing in the computation
        reads their values on the host, so one captured program serves every
        chunk offset, as the reference's traced ``start`` does.  Rows past the
        real prompt are causally dead; cache writes past ``cache_len`` are
        dropped.  An MoE chunk routes its own S x B tokens (its capacity
        follows the chunk's length, as the reference's).  The cache is updated
        in place and returned with the f32 logits (B, 1, V_padded).
        """
        if not self.supports_chunked_prefill():
            raise NotImplementedError(f"chunked prefill unsupported for this layout "
                                      f"(vlm={self.is_vlm}, kv_quant={self.kv_quant})")
        c = self.cfg
        b, s = tokens.shape
        start = torch.as_tensor(start, dtype=torch.int64, device=self.device)
        positions = start + torch.arange(s, device=self.device).expand(b, s)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        x = self._self_layers(params, x, positions, cache, chunk_start=start)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        if last_row is None:
            x_last = x[:, -1:]
        else:
            x_last = x.index_select(1, torch.as_tensor(last_row, dtype=torch.int64, device=self.device).reshape(1))
        return L.logits_from_hidden(params["emb"], x_last), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens: (B, 1); positions: (B,) — index of the new token.  A VLM's
        cross blocks attend over all of each group's cached image tokens.  The
        cache is updated in place and returned."""
        c = self.cfg
        b = tokens.shape[0]
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        after_group = None
        if self.is_vlm:
            def after_group(g, cross, x):
                ck, cv = cache["cross_k"][g], cache["cross_v"][g]
                q = ops.matmul(L.rms_norm(x, cross["ln1"], c.norm_eps), cross["attn"]["wq"])
                valid = torch.full((b,), ck.shape[1], dtype=torch.int64, device=self.device)
                bh = (0, 2)  # on each rank's shards of the batch or KV heads, if sharded
                h = L.on_shards(L.decode_attention, (L.split(q, b, 1, c.n_heads, c.head_dim), ck, cv, valid),
                                (bh, bh, bh, (0, None)), (bh,), heads=c.n_kv_heads)
                x = x + ops.matmul(h.reshape(b, 1, c.q_dim), cross["attn"]["wo"])
                return x + L.mlp_layer(cross["ffn"], L.rms_norm(x, cross["ln2"], c.norm_eps))

        x = self._self_layers(params, x, positions[:, None], cache, after_group, cache_positions=positions)
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
        return L.shard_act(x + h2), (new_wkv, last1, last2)

    def loss_fn(self, params: dict, batch: dict):
        """Mean token NLL from a zero state, each layer checkpointed.  Under
        grad each layer's WKV runs as the ``repro_torch::wkv`` op: on the card
        its backward is the WKV's backward kernel, on the CPU the plain
        version of the same algorithm."""
        x = L.embed_tokens(params["emb"], batch["tokens"].to(self.device)).to(self.dtype)
        body = L.ckpt(lambda x, blk: self._layer(blk, x, (None, None, None))[0])
        for i in ops.scan_layers(self.cfg.n_layers):
            x = body(x, _layer_params(params["blocks"], i))
        loss = _loss(params, x, self.cfg, batch)
        return loss, {"ce_loss": loss}

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
        for i in ops.scan_layers(self.cfg.n_layers):
            blk = _layer_params(params["blocks"], i)
            x, new = self._layer(blk, x, (cache["wkv"][i], cache["x1"][i], cache["x2"][i]))
            for key, t in zip(("wkv", "x1", "x2"), new):
                L.write(cache[key][i], t)
        return x

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Run the prompt ``batch["tokens"]`` (B, S) from a zero state; returns
        the f32 logits of the last position (B, 1, V_padded) and the state."""
        c = self.cfg
        tokens = batch["tokens"]
        cache = _placed_like(self.init_cache(tokens.shape[0], cache_len), params)
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
                "attn": _init_attention(c, normal, full),
                "mamba": M.init_mamba(c, normal, full),
                "ffn": _init_mlp(c, normal),
                "ln1": full((c.n_layers, c.d_model), 1.0),
                "ln2": full((c.n_layers, c.d_model), 1.0),
            },
        }

    def _layer(self, blk: dict, x, positions, kind: str, entry: dict | None, *, cache_positions=None,
               cache_valid=None):
        """One layer over ``entry`` = this layer's {"k", "v", "ssm"} cache: k/v
        are written in place; returns (x, the new ssm state).  ``entry=None``
        is the training forward: no cache."""
        c = self.cfg
        xn = L.rms_norm(x, blk["ln1"], c.norm_eps)
        h_attn = L.attention_layer(
            blk["attn"], xn, c, positions, cache=None if entry is None else (entry["k"], entry["v"]),
            cache_positions=cache_positions, cache_valid=cache_valid,
            window=0 if kind == "global" else c.window,
        )
        if entry is not None and x.shape[1] == 1:
            h_mamba, ssm = M.mamba_decode_step(blk["mamba"], xn, entry["ssm"], c)
        else:
            h_mamba, ssm = M.mamba_layer(blk["mamba"], xn, c)
        x = x + 0.5 * (h_attn + h_mamba)
        return L.shard_act(x + L.mlp_layer(blk["ffn"], L.rms_norm(x, blk["ln2"], c.norm_eps))), ssm

    def loss_fn(self, params: dict, batch: dict):
        """Mean token NLL, each layer checkpointed.  The layers scan here as
        the reference's ``loss_fn`` scans them (layer 0 selects; the window
        is each layer's own).  Under grad each layer's scan runs as the
        ``repro_torch::ssm_scan_fused`` op: on the card its backward is the
        fused scan's backward kernel, on the CPU the plain version of the same
        algorithm."""
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        body = L.ckpt(lambda x, blk, kind: self._layer(blk, x, positions, kind, None)[0])
        kinds = self._layer_kinds()
        for i in ops.scan_layers(self.cfg.n_layers):
            x = body(x, _layer_params(params["blocks"], i), kinds[i])
        loss = _loss(params, x, self.cfg, batch)
        return loss, {"ce_loss": loss}

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
        cache = _placed_like(self.init_cache(b, cache_len), params)
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
            L.write(entry["ssm"], ssm)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x), cache


class EncDecLM:
    """Encoder-decoder (seamless-m4t-large-v2's backbone): an unmasked
    encoder with rope over the stubbed audio frames, then a decoder whose
    every layer is causal self-attention, cross-attention over the encoder's
    output (``memory``; no rope, no mask) and a SwiGLU FFN."""

    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = torch.device(device)

    def init(self, generator: torch.Generator | None = None) -> dict:
        """Random weights drawn from ``generator`` at the reference's scales."""
        c = self.cfg
        ne = c.n_enc_layers
        normal, full = _initializers(self, generator)
        return {
            "emb": _init_embedding(c, normal),
            "final_norm": full((c.d_model,), 1.0),
            "enc_norm": full((c.d_model,), 1.0),
            "encoder": {
                "attn": _init_attention(c, normal, full, ne),
                "ffn": _init_mlp(c, normal, ne),
                "ln1": full((ne, c.d_model), 1.0),
                "ln2": full((ne, c.d_model), 1.0),
            },
            "decoder": {
                "attn": _init_attention(c, normal, full),
                "cross": _init_attention(c, normal, full),
                "ffn": _init_mlp(c, normal),
                "ln1": full((c.n_layers, c.d_model), 1.0),
                "ln_x": full((c.n_layers, c.d_model), 1.0),
                "ln2": full((c.n_layers, c.d_model), 1.0),
            },
        }

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S, d) stubbed audio-frontend embeddings -> memory (B, S, d)."""
        c = self.cfg
        b, s, _ = frames.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x = L.shard_act(frames.to(device=self.device, dtype=self.dtype))

        def body(x, blk):
            x = x + L.attention_layer(blk["attn"], L.rms_norm(x, blk["ln1"], c.norm_eps), c, positions,
                                      causal=False)
            return L.shard_act(x + L.mlp_layer(blk["ffn"], L.rms_norm(x, blk["ln2"], c.norm_eps)))

        body = L.ckpt(body)
        for i in ops.scan_layers(c.n_enc_layers):
            x = body(x, _layer_params(params["encoder"], i))
        return L.rms_norm(x, params["enc_norm"], c.norm_eps)

    def _dec_layer(self, blk: dict, x, positions, memory, *, cache=None, cache_positions=None):
        """Self-attention (its k/v written into ``cache`` in place, if given),
        cross-attention over ``memory``, FFN."""
        c = self.cfg
        x = x + L.attention_layer(blk["attn"], L.rms_norm(x, blk["ln1"], c.norm_eps), c, positions,
                                  cache=cache, cache_positions=cache_positions)
        x = x + L.attention_layer(blk["cross"], L.rms_norm(x, blk["ln_x"], c.norm_eps), c, None, kv_input=memory)
        return L.shard_act(x + L.mlp_layer(blk["ffn"], L.rms_norm(x, blk["ln2"], c.norm_eps)))

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, device=self.device).expand(b, s)

    def loss_fn(self, params: dict, batch: dict):
        """Mean token NLL of the decoder over ``batch["tokens"]`` given
        ``batch["frames"]``, every encoder and decoder layer checkpointed."""
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"].to(self.device)
        positions = self._positions(*tokens.shape)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        body = L.ckpt(lambda x, blk: self._dec_layer(blk, x, positions, memory))
        for i in ops.scan_layers(self.cfg.n_layers):
            x = body(x, _layer_params(params["decoder"], i))
        loss = _loss(params, x, self.cfg, batch)
        return loss, {"ce_loss": loss}

    def init_cache(self, b: int, cache_len: int) -> dict:
        """The decoder's self-attention k/v, (n_layers, B, T, KV, hd).  As the
        reference's, it lacks the ``memory`` leaf that :meth:`prefill` adds."""
        c = self.cfg
        shape = (c.n_layers, b, cache_len, c.n_kv_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    def _decode_layers(self, params: dict, x, positions, memory, cache: dict, cache_positions=None):
        for i in ops.scan_layers(self.cfg.n_layers):
            x = self._dec_layer(_layer_params(params["decoder"], i), x, positions, memory,
                                cache=(cache["k"][i], cache["v"][i]), cache_positions=cache_positions)
        return x

    def prefill(self, params: dict, batch: dict, cache_len: int):
        """Encode ``batch["frames"]`` and prefill the decoder with the token
        prefix ``batch["tokens"]`` (B, S); returns the f32 logits of the last
        position (B, 1, V_padded) and the cache with ``memory`` added."""
        c = self.cfg
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"].to(self.device)
        b, s = tokens.shape
        cache = _placed_like(self.init_cache(b, cache_len), params)
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        x = self._decode_layers(params, x, self._positions(b, s), memory, cache)
        cache["memory"] = memory
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x[:, -1:]), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor):
        """tokens: (B, 1); positions: (B,) — index of the new token.  Attends
        over ``cache["memory"]``; the k/v cache is updated in place and
        returned."""
        c = self.cfg
        x = L.embed_tokens(params["emb"], tokens).to(self.dtype)
        x = self._decode_layers(params, x, positions[:, None], cache["memory"], cache, cache_positions=positions)
        x = L.rms_norm(x, params["final_norm"], c.norm_eps)
        return L.logits_from_hidden(params["emb"], x), cache
