"""Shared model building blocks, ported from ``repro/models/layers.py``.

Functional, params-in: each function takes a dict of tensors laid out as the
JAX package lays them out ((in, out) matrices), so ``ops.matmul(x, w)``
hands the GEMM kernel exactly what the reference's kernel got.  Every GEMM
routes through ``kernels.ops.matmul``.  Attention is plain PyTorch code
(einsum, softmax) with the reference's masking: the reference has no kernel
there either.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ..core.runtime import current_runtime
from ..kernels import ops

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# activation sharding, as the reference's: models call shard_act() on the
# embedding and at every layer boundary.  On a DTensor it redistributes the
# (B, S, ...) activation to batch over the configured axes (by default the
# mesh's data axes, the reference launcher's constraint), so every layer of a
# stack sees the same placements, runs the same local kernel problems, and
# replays layer 0's selections (``ops.scan_layers``).  Plain tensors pass.
# ---------------------------------------------------------------------------
_ACT_SPEC: dict = {"batch": None, "seq": None}


def set_activation_sharding(batch_axes=None, seq_axes=None) -> None:
    _ACT_SPEC["batch"] = batch_axes
    _ACT_SPEC["seq"] = seq_axes


def act_spec(x: torch.Tensor, mesh):
    """The spec :func:`shard_act` gives a (B, S, ...) activation: the configured
    batch / seq axes, or with neither set the batch's spec on ``mesh``."""
    from ..dist.sharding import P, batch_pspecs

    batch, seq = _ACT_SPEC["batch"], _ACT_SPEC["seq"]
    if batch is None and seq is None:
        return batch_pspecs(x, mesh)
    spec = [None] * x.ndim
    spec[0] = batch
    if x.ndim >= 2:
        spec[1] = seq
    return P(*spec)


def _constrain(x: torch.Tensor, spec) -> torch.Tensor:
    from ..dist.sharding import placements

    target = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == target else x.redistribute(x.device_mesh, target)


def shard_act(x: torch.Tensor) -> torch.Tensor:
    """Constrain a (B, S, ...) DTensor activation to the configured DP / SP axes."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _constrain(x, act_spec(x, x.device_mesh))


# MoE dispatch-buffer sharding, as the reference's (set by the launcher; see
# ``moe.moe_ffn``).  Splitting the (E, C, ...) buffer's capacity dim over data
# turns the data ranks' all-reduce of their disjoint slots into a reduce-scatter.
_MOE_SPEC: dict = {"ep": None, "cap": None}


def set_moe_sharding(ep_axes=None, cap_axes=None) -> None:
    _MOE_SPEC["ep"] = ep_axes
    _MOE_SPEC["cap"] = cap_axes


def moe_buf_spec(ndim: int):
    """The spec :func:`shard_moe_buf` gives an (E, C, ...) buffer: experts over the
    configured ``ep`` axes, capacity over ``cap``; with neither set, the port's
    default, experts over ``model`` as the expert weights are and capacity
    replicated (the reference then leaves the buffer to GSPMD)."""
    from ..dist.sharding import P

    ep, cap = _MOE_SPEC["ep"], _MOE_SPEC["cap"]
    spec = [None] * ndim
    spec[0] = "model" if ep is None and cap is None else ep
    if ndim >= 2:
        spec[1] = cap
    return P(*spec)


def shard_moe_buf(x: torch.Tensor) -> torch.Tensor:
    """Constrain an (E, C, feature) DTensor MoE dispatch / expert buffer; plain tensors pass."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _constrain(x, moe_buf_spec(x.ndim))


def split(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)`` where the reshape splits a dim (the features into
    heads, heads into groups).  A DTensor sharded over mesh dims whose ways do
    not divide the split's outer size (8 KV heads on a 16-way ``model`` axis)
    is first replicated over the innermost of them until they do, as GSPMD
    reshards it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    keep = 0
    while keep < min(x.ndim, len(shape)) and x.shape[keep] == shape[keep]:
        keep += 1
    mesh = x.device_mesh
    target = list(x.placements)
    split_by = [i for i, pl in enumerate(target) if isinstance(pl, Shard) and pl.dim >= keep]
    ways = 1
    for i in split_by:
        ways *= mesh.size(i)
    for i in reversed(split_by):
        if keep >= len(shape) or shape[keep] % ways == 0:
            break
        target[i] = Replicate()
        ways //= mesh.size(i)
    if tuple(target) != tuple(x.placements):
        x = x.redistribute(mesh, target)
    return x.reshape(*shape)


def write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` first takes ``dst``'s placements
    (DTensor changes no placement in place)."""
    from torch.distributed.tensor import DTensor

    if isinstance(dst, DTensor) and isinstance(src, DTensor) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def on_shards(fn, args: tuple, dims: tuple, out_dims: tuple, *, heads: int, inplace: tuple = ()):
    """``fn(*args)`` on each rank's local shards, where an arg is a DTensor;
    ``fn(*args)`` itself otherwise.

    For a computation that is independent per batch row and per head
    (attention, a recurrence's decode step): ``dims[i]`` is arg i's (batch
    dim, head dim), either ``None``, or ``dims[i]`` is ``None`` for an arg
    passed as it is.  On each mesh dim the computation splits as ``args[0]``
    is split there (a plain ``args[0]`` counts as replicated): over the batch,
    over heads (where ``heads`` divides by the mesh dim), else not at all;
    every arg is redistributed to match, ``fn``
    runs on the local tensors, and its outputs come back as DTensors split
    the same way (``out_dims``).  An arg replicated over a mesh dim the
    computation splits gets its gradient there as a partial sum.  Args at
    ``inplace`` are written by ``fn``: where one had to be redistributed, the
    result is copied back into it.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    mesh = lead.device_mesh
    modes = []
    for i, size in enumerate(mesh.shape):
        pl = args[0].placements[i] if isinstance(args[0], DTensor) else Replicate()
        if isinstance(pl, Shard) and pl.dim == dims[0][0]:
            modes.append(0)
        elif isinstance(pl, Shard) and pl.dim == dims[0][1] and heads % size == 0:
            modes.append(1)
        else:
            modes.append(None)

    def place(d):
        return tuple(Shard(d[m]) if m is not None and d[m] is not None else Replicate() for m in modes)

    placed, local = [], []
    for a, d in zip(args, dims):
        if a is None or d is None:
            placed.append(a)
            local.append(a)
            continue
        t = a if isinstance(a, DTensor) else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        t = t if tuple(t.placements) == place(d) else t.redistribute(mesh, place(d))
        placed.append(t)
        # Replicated over a mesh dim the computation splits: each rank's gradient is its part of a sum.
        grads = tuple(Partial() if m is not None and not isinstance(pl, Shard) else pl
                      for m, pl in zip(modes, t.placements))
        local.append(t.to_local(grad_placements=grads))
    out = fn(*local)
    for i in inplace:
        if isinstance(args[i], DTensor) and placed[i] is not args[i]:
            with torch.no_grad():
                args[i].copy_(placed[i].redistribute(mesh, args[i].placements))
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, place(d), run_check=False) for o, d in zip(outs, out_dims))
    return wrapped if isinstance(out, tuple) else wrapped[0]


# ---------------------------------------------------------------------------
# remat (activation checkpoint) policy, as the reference's.
# 'full' recomputes the whole layer in the backward (least memory, 4F flops);
# 'dots' keeps the GEMM outputs and recomputes only the cheap ops between them
# (3F flops, more activation memory).
# ---------------------------------------------------------------------------
_REMAT: dict = {"policy": "full"}


def set_remat_policy(policy: str) -> None:
    if policy not in ("full", "dots"):
        raise ValueError(f"remat policy must be 'full' or 'dots', got {policy!r}")
    _REMAT["policy"] = policy


def _save_gemms(ctx, op, *args, **kwargs):
    """Remat ``"dots"``: keep every kernel GEMM's output, recompute the rest."""
    if op is ops.GEMM_OP:
        if not ctx.is_recompute:
            ops.GRAD_GEMMS["saved"] += 1
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def ckpt(fn):
    """``fn`` checkpointed with the configured policy (each layer body of a
    training forward).

    Both policies are ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
    the backward runs ``fn`` again to rebuild what it saved.  Under ``"dots"`` a
    selective-checkpoint policy saves the output of every GEMM (the
    ``repro_torch::gemm`` op that ``ops.matmul`` runs under grad) and the
    recompute takes them back instead of launching, which is what JAX's
    ``dots_with_no_batch_dims_saveable`` keeps.  The runtime active at the
    forward is activated for the recompute, which on the card runs on
    autograd's device thread.  The forward draws no random numbers, so no RNG
    state is stashed.
    """

    def wrapped(*args):
        if not torch.is_grad_enabled():  # nothing to save for a backward
            return fn(*args)
        rt = current_runtime()
        runs = []

        def run(*a):
            # The first run counts under the enclosing phase (a nested checkpoint's
            # forward inside an outer recompute is a recompute), later runs as recomputes.
            label = "recompute" if runs else ops.gemm_phase_label()
            runs.append(label)
            with rt.activate(), ops.gemm_phase(label):
                return fn(*a)

        dots = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _save_gemms)}
        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                                                 **(dots if _REMAT["policy"] == "dots" else {}))

    return wrapped


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to ``x.dtype``."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding on the two halves of the head dim (not interleaved pairs).

    x: (B, S, H, hd); positions: (B, S) absolute token positions.
    """
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions.float()[:, :, None, None] * freqs  # (B, S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked flash attention (grouped-query layout, no KV repeat)
# ---------------------------------------------------------------------------
def _attn_chunk(q, k, v, row0, col0: int, scale: float, window: int = 0, causal: bool = True):
    """One (q-chunk x kv-chunk) tile.  q: (B,KV,G,Lq,hd)  k/v: (B,KV,Lk,hd).
    ``row0`` (an int, or a 0-d tensor in a chunk-append call) is the first
    query's position.  ``causal`` masks columns after the row and, with
    ``window`` > 0, columns at or before ``row - window``; otherwise nothing
    is masked."""
    logits = torch.einsum("bkgqh,bkth->bkgqt", q.float(), k.float()) * scale
    if causal:
        rows = row0 + torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = col0 + torch.arange(k.shape[-2], device=q.device)[None, :]
        masked = cols > rows
        if window:
            masked |= cols <= rows - window
        logits = logits.masked_fill(masked, _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgqt,bkth->bkgqh", p, v.float())


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_start: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grouped-query online-softmax attention (``flash_attention_jnp``).

    q: (B, S, H, hd) with H = KV * G;  k/v: (B, T, KV, hd).  ``causal=False``
    lets every query see every column (cross-attention over T image tokens,
    S != T).  The causal diagonal is aligned to the end of KV (query i sits
    at position T - S + i), or, with ``q_start`` (a 0-d tensor: chunked prefill), query i sits at
    position ``q_start + i`` and attends over the whole cache up to it.  The
    mask is built from the tensor, so one captured program serves every
    offset.
    ``window`` > 0 is causal sliding-window attention: a query at position r sees
    columns c with r - window < c <= r.  Memory is bounded by q_chunk x
    kv_chunk tiles.  The last chunk of each axis is simply shorter: the
    reference pads it and masks the pad columns at -1e30, which contributes
    exactly nothing to a row that has a real column, and every row has one
    (its own diagonal, or every column when not causal).
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / (hd**0.5)
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)  # (B,KV,G,S,hd)
    kt = k.permute(0, 2, 1, 3)  # (B,KV,T,hd)
    vt = v.permute(0, 2, 1, 3)
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    diag_off = t - s if q_start is None else q_start
    blocks = []
    for q0 in range(0, s, qc):
        qblk = qg[:, :, :, q0 : q0 + qc]
        lq = qblk.shape[3]
        m = torch.full((b, kvh, g, lq), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, lq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, lq, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, t, kc):
            m_c, l_c, o_c = _attn_chunk(
                qblk, kt[:, :, k0 : k0 + kc], vt[:, :, k0 : k0 + kc],
                q0 + diag_off, k0, scale, window, causal,
            )
            m_new = torch.maximum(m, m_c)
            corr = torch.exp(m - m_new)
            corr_c = torch.exp(m_c - m_new)
            l = l * corr + l_c * corr_c
            acc = acc * corr[..., None] + o_c * corr_c[..., None]
            m = m_new
        blocks.append((acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype))
    out = torch.cat(blocks, dim=3)  # (B,KV,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-token attention over a (B, T, KV, hd) cache (``decode_attention_jnp``).

    ``valid_len`` (B,): number of valid cache slots per sequence.  Logits
    accumulate in f32; the probabilities are cast to the cache dtype before
    the value product, as in the reference.  An int8 cache passes its
    per-(B, T, KV) ``k_scale`` / ``v_scale``: the dequantization folds into
    the logits (times ``k_scale`` along T) and into the probabilities (times
    ``v_scale`` before the value product, cast to q's dtype), as the
    reference folds it.
    """
    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / (hd**0.5)
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg.float(), k_cache.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, :]  # (B,KV,1,T)
    cols = torch.arange(t, device=q.device)[None, :]
    mask = cols < valid_len[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    v_dtype = q.dtype if v_cache.dtype == torch.int8 else v_cache.dtype
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v_dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 KV quantization (per-token, per-kv-head absmax scales)
# ---------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, KV, hd) -> int8 values and f32 scales over the hd axis: absmax / 127,
    rounded half to even (as ``jnp.round``) and clipped to ±127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _write_chunk(cache: torch.Tensor, src: torch.Tensor, start: torch.Tensor) -> None:
    """Write ``src`` (B, S, …) at cache positions ``[start, start + S)`` in place,
    dropping rows past the cache's end (a padded final chunk), as the
    reference's ``.at[:, pos].set(..., mode="drop")``.  Each cache slot takes
    its chunk row or keeps its value, chosen from ``start`` as a tensor, so no
    index repeats and no Python value depends on ``start``."""
    t, s = cache.shape[1], src.shape[1]
    rel = torch.arange(t, device=cache.device) - start
    inside = (rel >= 0) & (rel < s)
    rows = src.index_select(1, rel.clamp(0, s - 1))
    cache.copy_(torch.where(inside.view(1, t, *([1] * (cache.ndim - 2))), rows, cache))


# ---------------------------------------------------------------------------
# attention layer (GQA), cache-aware
# ---------------------------------------------------------------------------
def attention_layer(
    p: dict,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor | None,
    *,
    cache: tuple[torch.Tensor, ...] | None = None,
    cache_positions: torch.Tensor | None = None,
    cache_valid: torch.Tensor | None = None,
    window: int = 0,
    chunk_start: torch.Tensor | None = None,
    kv_input: torch.Tensor | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention for one layer (params already sliced to this layer).

    Optional ``bq`` / ``bk`` / ``bv`` biases (qwen2.5) are added after their
    GEMMs, before the reshape and rope, as the reference adds them.
    ``kv_input`` (B, T, d) makes it cross-attention: k/v come from it, with no
    rope, no mask and no cache (``positions`` unused).  ``causal=False``
    without a cache is unmasked self-attention (an encoder's), with rope.  Otherwise
    ``cache = (k_cache, v_cache)``, each (B, T, KV, hd), or, for an int8 cache,
    ``(k, v, k_scale, v_scale)`` with (B, T, KV) f32 scales.  Modes:
      * prefill: s > 1 — x attends over itself, causally (within ``window``
        when > 0).  With s < T, k/v are written to positions [0, s); with
        s >= T the cache is a ring buffer (a sliding window's): it keeps the
        last T tokens, each at its ring slot p % T, so decode can continue.
        An int8 cache stores them quantized; attention runs on the
        unquantized k/v;
      * decode: cache set, s == 1 — k/v are written at ``cache_positions``
        (B,) and the token attends over slots ``< cache_valid`` (default
        ``cache_positions + 1``);
      * chunk append (chunked prefill): ``chunk_start`` a 0-d tensor — k/v
        are written at ``[chunk_start, chunk_start + s)`` (rows past T are
        dropped) and the chunk attends causally over the whole cache from
        those positions.  An int8 cache refuses it, as the reference does.

    The cache is updated in place (the reference returns a new one); it is a
    view into the caller's cache, so no per-step copy is made.
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_src = x if kv_input is None else kv_input
    q = ops.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    k = ops.matmul(kv_src, p["wk"])
    v = ops.matmul(kv_src, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    q = split(q, b, s, h, hd)
    k = split(k, b, kv_src.shape[1], kvh, hd)
    v = split(v, b, kv_src.shape[1], kvh, hd)
    if kv_input is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # Sharded (DTensor) q / k / v: the cache writes and the attention run on each rank's
    # shards of the batch or of the KV heads (on_shards), as GSPMD partitions them.
    cache = tuple(cache) if cache is not None else ()
    cross = kv_input is not None

    def attend(q, k, v, cache_positions, cache_valid, chunk_start, *cache):
        return _attend(q, k, v, cache, cache_positions, cache_valid, window, chunk_start, cross, causal)

    bh = (0, 2)  # (batch, head) dims of q, k, v, the cache and its int8 scales
    out = on_shards(attend, (q, k, v, cache_positions, cache_valid, chunk_start, *cache),
                    (bh, bh, bh, (0, None), (0, None), None, *([bh] * len(cache))), (bh,), heads=kvh,
                    inplace=tuple(range(6, 6 + len(cache))))
    return ops.matmul(out.reshape(b, s, h * hd), p["wo"])


def _attend(q, k, v, cache, cache_positions, cache_valid, window, chunk_start, cross, causal):
    """The cache writes and attention of :func:`attention_layer` (q: (B, S, H, hd)
    after rope; k, v: (B, T, KV, hd)); returns (B, S, H, hd)."""
    b, s = q.shape[:2]
    if not cache:  # no cache: self-attention over x, or cross-attention over kv_input
        return flash_attention(q, k, v, causal=causal and not cross, window=window)
    quant = len(cache) == 4
    k_cache, v_cache = cache[:2]
    if s == 1 and chunk_start is None:  # decode: write one token per row
        bidx = torch.arange(b, device=q.device)
        if quant:
            (kq, ks), (vq, vs) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
            rows = (kq, vq, ks, vs)
        else:
            rows = (k[:, 0], v[:, 0])
        for dst, src in zip(cache, rows):
            dst[bidx, cache_positions] = src
        valid = cache_valid if cache_valid is not None else cache_positions + 1
        out = decode_attention(q, k_cache, v_cache, valid,
                               k_scale=cache[2] if quant else None, v_scale=cache[3] if quant else None)
    elif chunk_start is not None:  # chunk append: write [start, start + s)
        if quant:
            raise NotImplementedError("chunked prefill does not support int8 KV caches")
        _write_chunk(k_cache, k, chunk_start)
        _write_chunk(v_cache, v, chunk_start)
        out = flash_attention(q, k_cache, v_cache, window=window, q_start=chunk_start)
    else:  # prefill: write the whole prefix
        t_cache = k_cache.shape[1]
        if quant:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            writes = zip(cache, (kq, vq, ks, vs))
        else:
            writes = ((k_cache, k), (v_cache, v))
        for dst, src in writes:
            if s >= t_cache:  # ring buffer: token p lands in slot p % t_cache
                dst.copy_(torch.roll(src[:, -t_cache:], (s - t_cache) % t_cache, dims=1))
            else:
                dst[:, :s] = src
        out = flash_attention(q, k, v, window=window)
    return out


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_layer(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = ops.matmul(x, p["w_gate"])
    up = ops.matmul(x, p["w_up"])
    act = torch.nn.functional.silu(gate.float()).to(x.dtype)
    return ops.matmul(act * up, p["w_down"])


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def table_grad(tokens: torch.Tensor, grad_rows: torch.Tensor, rows: int, dtype: torch.dtype) -> torch.Tensor:
    """The gradient of ``table[tokens]`` for a (rows, d) table: each token's
    gradient rows summed in f32 in the order they occur, cast once.

    The rows are gathered in the tokens' stable sort order and
    ``segment_reduce`` sums each run of one token (one thread a run and
    column, in order), over as many runs as there are tokens (the runs past
    the last have no rows); each run's sum lands on its own table row, the
    empty runs' zeros on a spare row.  No float atomics and no host sync.
    Autograd's gradient of ``table[tokens]`` adds the rows of a repeated token
    with atomics on the card, in an order that changes between runs."""
    flat = tokens.reshape(-1)
    d = grad_rows.shape[-1]
    ids, order = torch.sort(flat, stable=True)
    start = torch.ones_like(ids, dtype=torch.bool)
    start[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(start, 0) - 1  # each sorted row's run
    lengths = torch.zeros_like(ids).index_add_(0, run, torch.ones_like(ids))
    sums = torch.segment_reduce(grad_rows.reshape(-1, d).float().index_select(0, order), "sum", lengths=lengths,
                                axis=0, unsafe=True)
    row = torch.full_like(ids, rows).index_put_((run,), ids)  # a run's table row; empty runs the spare one
    out = torch.zeros((rows + 1, d), dtype=dtype, device=grad_rows.device)
    out[row] = sums.to(dtype)  # every row once, but the spare row's zeros
    return out[:rows]


class _TableRows(torch.autograd.Function):
    """``table[tokens]`` with :func:`table_grad` as its backward."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        return table_grad(tokens, grad, ctx.rows, ctx.dtype), None


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``, anchored as the reference anchors every
    embedding (:func:`shard_act`).  A sharded table is gathered whole onto
    every rank, which looks up its own tokens (:func:`on_shards`); its
    gradient goes back to the table's placements as a reduce-scatter.  The
    table's gradient is :func:`table_grad`, repeatable bit for bit (on meta
    tensors, the dry run's, autograd's own: its run lengths have no shape)."""
    rows = on_shards(lambda t, w: w[t] if w.is_meta else _TableRows.apply(w, t), (tokens, p["embed"]),
                     ((0, None), (None, None)), ((0, None),), heads=1)
    return shard_act(rows)


def logits_from_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits over the padded vocab.

    Untied models carry ``unembed`` (d, V).  Tied models carry ``embed_t``,
    a contiguous copy of ``embed.T`` made once at load: the kernel takes
    row-major operands, and a per-call transpose copy would move the whole
    vocab matrix every step.  In training (grad on and ``embed`` requiring
    it) the head computes from ``embed`` itself, through a transpose copy
    made in the graph, so the gradient reaches ``embed``; the train step
    refreshes ``embed_t`` after each update.
    """
    if "unembed" in p:
        w = p["unembed"]
    elif torch.is_grad_enabled() and p["embed"].requires_grad:
        w = p["embed"].t().contiguous()
    else:
        w = p["embed_t"]
    return ops.matmul(x, w, out_dtype=torch.float32)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean token NLL; padded-vocab slots are masked out of the softmax."""
    pv = logits.shape[-1]
    if pv != vocab:
        logits = logits.masked_fill(torch.arange(pv, device=logits.device) >= vocab, _NEG_INF)
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    # (B, S, 1) throughout: on a vocab-sharded DTensor the gathered gold logit is a
    # masked partial sum, which DTensor reduces only at the shape the gather gave it.
    gold = torch.gather(logits, -1, targets[..., None].long())
    return (logz - gold).mean()
