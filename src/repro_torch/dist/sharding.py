"""PartitionSpec rules for every tree the launchers shard, ported from
``repro/dist/sharding.py``, and their DTensor placements.

The rules are the reference's, name for name and rank for rank, so a spec
here equals the reference's ``PartitionSpec`` entry for entry.  A spec is a
:class:`P`: a tuple with one entry per tensor dim, each ``None``, a mesh
axis name, or a tuple of names (a dim split over several mesh axes, major
first).  The functions read only shapes and names, so they take real, meta
or DTensor leaves alike and need no process group.

Mesh axis conventions (see ``repro_torch.launch.mesh``):
  ``pod``   — outermost data-parallel axis across pods (optional);
  ``data``  — data parallel / FSDP axis;
  ``model`` — tensor / expert parallel axis.

Parameter rules (name = innermost dict key, rank includes the stacked layer
axis that every per-block param carries at axis 0):
  * rank-1/2 vectors and per-layer norms / gates — replicated;
  * ``embed`` (V, d) — vocab over ``model``, features over ``data``;
  * ``unembed`` (d, V) — column-parallel; a tied model's ``embed_t`` (the
    port's load-time copy of ``embed.T``, absent from the reference) too;
  * rank-3 GEMM weights — column-parallel ``P(None, data, model)`` by
    default; known output projections row-parallel ``P(None, model, data)``;
    tiny-state SSM / router matrices FSDP-only; per-head decay / bonus
    tables replicated;
  * rank-4 MoE expert stacks (L, E, d, ff) — experts over ``model`` (EP),
    FSDP over the next dim.

:func:`placements` maps a spec onto a ``DeviceMesh``: one DTensor placement
per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that mesh dim and
``Replicate()`` elsewhere.  A dim named by several mesh dims is sharded on
each, in mesh order, which is the order JAX splits it in.
"""
from __future__ import annotations

import torch

from ..optim.adamw import like_tree

# Output projections: input dim is the sharded (model) dim — row-parallel.
_ROW_PARALLEL = {"wo", "w_o", "w_out", "w_down", "w_cv", "wd2", "w_dt2"}
# Tiny trailing state dims (SSM B/C/A, router logits): FSDP the d dim only.
_FSDP_ONLY = {"w_b", "w_c", "a_log", "router"}
# Per-head tables too small to shard at all.
_REPLICATED = {"ln_w", "u"}


class P(tuple):
    """A partition spec: ``P(None, "data", "model")``, one entry per tensor dim.
    A one-name tuple entry is that name, as ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or a sequence of names."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", mesh)
    return tuple(names)


def _map(tree, fn, name: str = ""):
    """``fn(name, leaf)`` over a tree of dicts (``name``: the innermost dict key)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def param_pspecs(params, mesh):
    """Spec tree mirroring ``params`` (one P per leaf)."""
    axes = axis_names(mesh)
    tp = "model" if "model" in axes else None
    fsdp = "data" if "data" in axes else None

    def spec(name: str, leaf) -> P:
        rank = len(leaf.shape)
        if rank <= 1:
            return P()
        if rank == 2:
            if name == "embed":
                return P(tp, fsdp)
            if name in ("unembed", "embed_t"):
                return P(fsdp, tp)
            return P()  # per-layer (L, d) norms / mixing vectors
        if rank == 3:
            if name in _REPLICATED:
                return P()
            if name in _FSDP_ONLY:
                return P(None, fsdp, None)
            if name in _ROW_PARALLEL:
                return P(None, tp, fsdp)
            return P(None, fsdp, tp)  # column-parallel default
        if rank == 4:  # MoE expert stacks (L, E, d, ff) / (L, E, ff, d)
            return P(None, tp, fsdp, None)
        return P(*([None] * rank))

    return _map(params, spec)


def _dp(axes: tuple):
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return dp


def batch_pspecs(tree, mesh, *, shard_seq: bool = False):
    """Input batches: DP over the leading batch dim (SP over sequence).  A
    single tensor gives a single spec."""
    axes = axis_names(mesh)
    dp = _dp(axes)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)

    def spec(_name, leaf) -> P:
        rank = len(leaf.shape)
        if rank == 0:
            return P()
        if shard_seq:
            # batch=1 long-context: shard the sequence dim instead.
            if rank == 1:
                return P(None)
            seq = "data" if "data" in axes else None
            return P(None, seq, *([None] * (rank - 2)))
        return P(dp_spec, *([None] * (rank - 1)))

    return _map(tree, spec)


def cache_pspecs(cache, mesh, *, shard_seq: bool = False, kv_seq_axis: str | None = None):
    """KV / state caches: DP over batch; context-parallel over seq when asked.

    Layer-stacked leaves (rank >= 4: (L, B, T, H, hd) KV, (L, B, H, hd, hd)
    WKV state) carry batch at axis 1; flat leaves (an encoder's ``memory``
    (B, S, d), Hymba's per-layer ``ssm`` (B, d, N)) at axis 0.  With
    ``shard_seq`` the KV sequence dim is sharded over ``data`` (or
    ``kv_seq_axis``); sequence-free state leaves shard their next dim over
    ``model`` instead.
    """
    axes = axis_names(mesh)
    dp = _dp(axes)
    tp = "model" if "model" in axes else None

    def spec(name: str, leaf) -> P:
        rank = len(leaf.shape)
        if rank == 0:
            return P()
        batch_axis = 1 if rank >= 4 else 0
        out = [None] * rank
        if not shard_seq:
            out[batch_axis] = dp if dp else None
            return P(*out)
        seq_axis = batch_axis + 1
        if seq_axis < rank:
            if name.startswith(("k", "v", "memory")):
                out[seq_axis] = kv_seq_axis or ("data" if "data" in axes else None)
            else:  # sequence-free resident state: split heads instead
                out[seq_axis] = tp
        return P(*out)

    return _map(cache, spec)


def opt_pspecs(opt, param_spec):
    """Optimizer-state specs: moments mirror the params (derived leaves
    left out, as the moments hold none), step is replicated."""
    moments = like_tree(param_spec, lambda s: s)
    return type(opt)(step=P(), m=moments, v=moments)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def placements(spec, mesh) -> tuple:
    """One DTensor placement per mesh dim for a tensor of spec ``spec``:
    ``Shard(d)`` where tensor dim ``d``'s entry names the mesh dim (alone or
    in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_names(mesh):
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple) and axis in entry)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names mesh axis {axis!r} on tensor dims {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _zip(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return type(tree)(**{k: _zip(v, getattr(specs, k), fn) for k, v in tree._asdict().items()})
    return fn(tree, specs)


def placement_tree(specs, mesh):
    """``specs`` with each spec replaced by its ``(mesh, placements)`` pair
    (what ``CheckpointManager.restore(placements=)`` takes)."""
    return _zip(specs, specs, lambda spec, _: (mesh, placements(spec, mesh)))


def distribute_tree(tree, specs, mesh):
    """Each leaf of ``tree`` (a tree of dicts and NamedTuples of full tensors,
    equal on every rank) as a DTensor on ``mesh`` with its spec's placements,
    each rank keeping its own shard (no communication); a leaf that is
    already a DTensor is redistributed to them."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(leaf, spec):
        target = placements(spec, mesh)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, target)
        with torch.no_grad():
            out = distribute_tensor(leaf.detach(), mesh, target, src_data_rank=None)
        return out.requires_grad_(leaf.requires_grad)

    return _zip(tree, specs, put)


def gather_tree(tree):
    """The inverse of :func:`distribute_tree`: every DTensor leaf as its full
    tensor (a collective: every rank calls it), other leaves as they are."""
    from torch.distributed.tensor import DTensor

    def full(leaf):
        if isinstance(leaf, DTensor):
            with torch.no_grad():
                return leaf.full_tensor()
        return leaf

    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return type(tree)(**{k: gather_tree(v) for k, v in tree._asdict().items()})
    return full(tree)

