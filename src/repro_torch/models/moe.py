"""Mixture-of-Experts FFN, ported from ``repro/models/moe.py``.

Token-choice top-k routing into capacity buckets, step by step as the
reference:

  1. the router GEMM through ``ops.matmul`` (f32 logits), softmax, top-k with
     the gates renormalised, and the Switch load-balance aux loss;
  2. each assignment's position within its expert (a cumsum over expert
     one-hots, k-major per token), ``capacity = max(1, int(T k / E cf))``;
     assignments past capacity are dropped (their slot clamped, their
     contribution zero);
  3. a scatter-add of the tokens into an (E, C, d) buffer;
  4. the per-expert SwiGLU as three einsums over the experts;
  5. the gather back (``y`` cast to the activation dtype first) and the
     gate-weighted sum over k.

The expert products are ``torch.einsum`` (a library batched GEMM), as the
reference computes them with ``jnp.einsum`` outside any Pallas kernel; the
router goes through the tuned GEMM.  Nothing here reads a value on the host
(capacity is a Python int of the static shapes), so a CUDA graph can capture
it: the one-hots are a comparison, the scatter an ``index_add_``.

**Under DTensor** (a sharded train step, the dry run) the layer computes what
the unsharded layer computes on the global batch, as the reference's one
program partitioned by GSPMD: the same capacity over the global T, the same
kept set (an assignment's slot is its position in the global token order),
the same outputs.  Each rank holds its data shard's tokens, replicated over
``model``, and its ``model`` coordinate's E / model experts:

  * it routes its own tokens (the router gathered, as FSDP gathers it) and
    counts its assignments per expert; only those (E,) counts are gathered
    over the data axes, and the counts of the lower data ranks, added to
    the local cumsum, give each assignment its global slot;
  * it scatters its kept tokens bound for its own experts into an
    (E / model, C, d) buffer; the data ranks' slots are disjoint, so the
    buffer is their sum (``Partial`` over data), which
    ``layers.shard_moe_buf`` resolves: an all-reduce to capacity replicated
    by default, a reduce-scatter along C under ``moe_cap_data``;
  * the three einsums run on the local experts and capacity rows, the
    weights gathered over ``data`` (their FSDP dim);
  * the combine picks each of its assignments' rows of its own experts
    (other experts' rows count as zero) and the partial outputs are summed
    over ``model``;
  * the aux loss's ``me`` and ``ce`` are global means (``me``: each model
    rank contributes its own experts' entries, so its gradient is counted
    once).

No rank gathers another's tokens or one-hots, every shape is static, and
every collective is a DTensor redistribution, so it carries its gradient
and ``commanalysis`` counts it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops
from . import layers as L

DATA_AXES = ("pod", "data")  # the mesh axes a batch is split over
EXPERT_AXIS = "model"  # the mesh axis the expert weights are split over


class Route(NamedTuple):
    """Where a layer's tokens go.  Sharded: this rank's tokens, slots in the global order."""

    gate_vals: torch.Tensor  # (T, k) renormalised gates
    flat_e: torch.Tensor  # (T * k,) each assignment's expert, k-major per token
    slot: torch.Tensor  # (T * k,) its slot, clamped to capacity - 1
    keep: torch.Tensor  # (T * k,) bool: within capacity
    capacity: int
    aux: torch.Tensor  # f32 load-balance loss (sharded: a replicated DTensor)


def init_moe(cfg, normal, n_layers: int | None = None) -> dict:
    """Stacked MoE params at the reference's scales: the router (n, d, E) at
    (2 / (d + E))^0.5, the experts (n, E, d, ff) / (n, E, ff, d) at 0.02."""
    n = n_layers if n_layers is not None else cfg.n_layers
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": normal((n, d, e), (2.0 / (d + e)) ** 0.5),
        "w_gate": normal((n, e, d, ff), 0.02),
        "w_up": normal((n, e, d, ff), 0.02),
        "w_down": normal((n, e, ff, d), 0.02),
    }


def route(p: dict, x: torch.Tensor, cfg) -> Route:
    """The routing of ``x`` (B, S, d); for a DTensor ``x``, of this rank's tokens."""
    if isinstance(x, DTensor):
        return _sharded_route(p, x, cfg)[0]
    b, s, d = x.shape
    e, top_k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    router_logits = ops.matmul(xt, p["router"], out_dtype=torch.float32)
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    # jax.lax.top_k puts the lower index first among equal values; a stable
    # descending sort does too (torch.topk promises no order among ties).
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = ranked.values[:, :top_k], ranked.indices[:, :top_k]  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Load-balance aux loss (Switch): E * sum_e f_e * p_e.
    flat_e = expert_ids.reshape(-1)  # (T*k,) — k-major per token
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(t * top_k, dtype=torch.float32, device=dev)) / (t * top_k)
    aux = e * torch.sum(me * ce)

    # Position of each assignment within its expert's capacity bucket.
    onehot = (flat_e[:, None] == torch.arange(e, device=dev)).to(torch.int64)  # (T*k, E)
    pos_in_e = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)  # (T*k,)
    capacity = max(1, int(t * top_k / e * cfg.moe.capacity_factor))
    keep = pos_in_e < capacity
    slot = torch.clamp(pos_in_e, max=capacity - 1)
    return Route(gate_vals, flat_e, slot, keep, capacity, aux)


def _per_assignment(xt: torch.Tensor, top_k: int) -> torch.Tensor:
    """(T, d) tokens -> (T * k, d), each token once for each of its k assignments."""
    t, d = xt.shape
    return xt[:, None].expand(t, top_k, d).reshape(t * top_k, d)


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), f32 aux loss).  Params already sliced to one layer."""
    if isinstance(x, DTensor):
        return _sharded_moe_ffn(p, x, cfg)
    b, s, d = x.shape
    top_k = cfg.moe.top_k
    t = b * s
    xt = x.reshape(t, d)
    r = route(p, x, cfg)
    e, capacity = cfg.moe.n_experts, r.capacity
    row = r.flat_e * capacity + r.slot  # the assignment's row of the (E * C, d) buffer

    # Dispatch: a dropped assignment adds exact zeros at its clamped slot, so the
    # sum is the same in any order.  Each assignment's token is an expand, whose
    # backward sums a token's k gradients in a fixed order (an index_select's
    # backward adds them with atomics, in an order that changes between runs).
    buf = torch.zeros((e * capacity, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, row, _per_assignment(xt, top_k) * r.keep[:, None].to(x.dtype))
    buf = buf.view(e, capacity, d)

    # Expert SwiGLU.
    gate = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    up = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    # Combine: each assignment's expert output (y cast before the gather), weighted, summed over k.
    picked = y.to(x.dtype).reshape(e * capacity, d).index_select(0, row)
    out_flat = picked * (r.keep[:, None] * r.gate_vals.reshape(-1)[:, None]).to(x.dtype)
    out = out_flat.reshape(t, top_k, d).sum(dim=1)
    return out.reshape(b, s, d), r.aux


# ---------------------------------------------------------------------------
# the sharded layer
# ---------------------------------------------------------------------------
class _Layout(NamedTuple):
    mesh: object
    data_dims: tuple  # mesh dims of the data axes, outermost first
    expert_dim: int | None  # mesh dim of the expert axis
    data_index: int  # this rank's data shard: its place in the global token order
    first: int  # this rank's first expert
    n_local: int  # experts this rank holds

    def placements(self, data, experts, other=Replicate()) -> tuple:
        """One placement per mesh dim: ``data`` on the data axes, ``experts`` on the expert axis."""
        return tuple(data if i in self.data_dims else experts if i == self.expert_dim else other
                     for i in range(self.mesh.ndim))

    def replicated(self) -> tuple:
        return (Replicate(),) * self.mesh.ndim


def _layout(mesh, n_experts: int) -> _Layout:
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    data_dims = tuple(i for i, name in enumerate(names) if name in DATA_AXES)
    index = 0
    for i in data_dims:
        index = index * mesh.size(i) + coord[i]
    expert_dim = names.index(EXPERT_AXIS) if EXPERT_AXIS in names else None
    ways = mesh.size(expert_dim) if expert_dim is not None else 1
    if n_experts % ways:
        raise ValueError(f"{n_experts} experts do not split over a {ways}-way {EXPERT_AXIS!r} axis")
    n_local = n_experts // ways
    first = (coord[expert_dim] if expert_dim is not None else 0) * n_local
    return _Layout(mesh, data_dims, expert_dim, index, first, n_local)


def _wrap(local: torch.Tensor, lay: _Layout, placements, shape) -> DTensor:
    """``local`` as this rank's part of a contiguous global ``shape`` (shards may be uneven)."""
    return DTensor.from_local(local, lay.mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _sharded_route(p: dict, x: DTensor, cfg):
    """(this rank's ``Route``, its tokens (T_local, d) as a local tensor, the layout)."""
    b, s, d = x.shape
    e, top_k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    lay = _layout(x.device_mesh, e)
    mesh = lay.mesh
    # This rank's tokens, replicated over the expert axis; the expert ranks' gradients of them
    # are each a part (their own experts' share).
    x_l = x.redistribute(mesh, lay.placements(Shard(0), Replicate())).to_local(
        grad_placements=lay.placements(Shard(0), Partial()))
    t_l = x_l.shape[0] * x_l.shape[1]
    xt = x_l.reshape(t_l, d)
    dev = xt.device
    router = p["router"]
    if isinstance(router, DTensor):
        router = router.redistribute(mesh, lay.replicated()).to_local(
            grad_placements=lay.placements(Partial(), Partial()))

    router_logits = ops.matmul(xt, router, out_dtype=torch.float32)
    probs = torch.softmax(router_logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = ranked.values[:, :top_k], ranked.indices[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_ids.reshape(-1)

    # Every data rank's assignments per expert, in the global token order.
    onehot = (flat_e[:, None] == torch.arange(e, device=dev)).to(torch.int32)  # (T_local*k, E)
    counts = DTensor.from_local(onehot.sum(0)[None], mesh, lay.placements(Shard(0), Replicate()),
                                run_check=False).redistribute(mesh, lay.replicated()).to_local()  # (n_data, E)
    before = counts[:lay.data_index].sum(0)  # assignments of the lower data ranks, per expert
    pos_in_e = ((torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1) * onehot).sum(-1) + before.index_select(0, flat_e)
    capacity = max(1, int(t * top_k / e * cfg.moe.capacity_factor))
    keep = pos_in_e < capacity
    slot = torch.clamp(pos_in_e, max=capacity - 1)

    # Load-balance aux loss over the global batch: me sums each data rank's share of the mean,
    # each expert rank contributing its own experts' entries.
    own = torch.zeros(e, dtype=torch.float32, device=dev)
    own[lay.first:lay.first + lay.n_local] = 1.0
    me = DTensor.from_local(probs.mean(0) * (t_l / t) * own, mesh, lay.placements(Partial(), Partial()),
                            run_check=False)
    for i in range(mesh.ndim):  # one mesh dim a reduction: every rank sums in the same order
        me = me.redistribute(mesh, (Replicate(),) * (i + 1) + tuple(me.placements[i + 1:]))
    me = me.to_local()
    ce = counts.sum(0).to(torch.float32) / (t * top_k)
    aux = DTensor.from_local(e * torch.sum(me * ce), mesh, lay.replicated(), run_check=False)
    return Route(gate_vals, flat_e, slot, keep, capacity, aux), xt, lay


def _local_weight(w, buf_placements, lay: _Layout) -> torch.Tensor:
    """An expert weight (E, ., .) as this rank's rows of the buffer's experts: split over the
    mesh dims that split the buffer's experts, gathered over the rest.  Its gradient is a part
    over the dims that split the buffer's capacity (each rank's rows contribute)."""
    if not isinstance(w, DTensor):
        return w
    target = tuple(pl if pl == Shard(0) else Replicate() for pl in buf_placements)
    grads = tuple(pl if pl == Shard(0) else Partial() if pl == Shard(1) else Replicate() for pl in buf_placements)
    return w.redistribute(lay.mesh, target).to_local(grad_placements=grads)


def _sharded_moe_ffn(p: dict, x: DTensor, cfg) -> tuple[DTensor, DTensor]:
    b, s, d = x.shape
    e, top_k = cfg.moe.n_experts, cfg.moe.top_k
    r, xt, lay = _sharded_route(p, x, cfg)
    t_l, capacity, dt = xt.shape[0], r.capacity, x.dtype
    mine = (r.flat_e >= lay.first) & (r.flat_e < lay.first + lay.n_local)
    sel = r.keep & mine  # kept and bound for this rank's experts
    row = torch.clamp(r.flat_e - lay.first, 0, lay.n_local - 1) * capacity + r.slot

    # Dispatch into this rank's experts' rows; the data ranks' slots are disjoint, so the
    # buffer is their sum, resolved by the buffer's constraint.
    buf = torch.zeros((lay.n_local * capacity, d), dtype=dt, device=xt.device)
    buf.index_add_(0, row, _per_assignment(xt, top_k) * sel[:, None].to(dt))
    buf = _wrap(buf.view(lay.n_local, capacity, d), lay, lay.placements(Partial(), Shard(0)), (e, capacity, d))
    buf = L.shard_moe_buf(buf)
    pb = buf.placements

    # Expert SwiGLU on the local experts and capacity rows.
    bl = buf.to_local()
    gate = torch.einsum("ecd,edf->ecf", bl, _local_weight(p["w_gate"], pb, lay))
    up = torch.einsum("ecd,edf->ecf", bl, _local_weight(p["w_up"], pb, lay))
    h = torch.nn.functional.silu(gate.float()).to(dt) * up
    y = torch.einsum("ecf,efd->ecd", h, _local_weight(p["w_down"], pb, lay))
    y = _wrap(y.to(dt), lay, pb, (e, capacity, d))  # placed as the buffer: the constraint holds

    # Combine: every capacity row of this rank's experts (each data rank's gradient of them a
    # part: its own tokens' rows), its assignments' rows picked; summed over the expert axis.
    y_l = y.redistribute(lay.mesh, lay.placements(Replicate(), Shard(0))).to_local(
        grad_placements=lay.placements(Partial(), Shard(0)))
    picked = y_l.reshape(lay.n_local * capacity, d).index_select(0, row)
    out_flat = picked * (sel[:, None] * r.gate_vals.reshape(-1)[:, None]).to(dt)
    out = out_flat.reshape(t_l, top_k, d).sum(dim=1).reshape(t_l // s, s, d)
    out = _wrap(out, lay, lay.placements(Shard(0), Partial()), (b, s, d))
    return out.redistribute(lay.mesh, lay.placements(Shard(0), Replicate())), r.aux
