"""Train-step construction, ported from ``repro/train/train_step.py``:
gradients (with microbatch accumulation) and the AdamW update.

  * ``num_microbatches`` splits the batch along its first axis and sums the
    microbatches' gradients in f32, as the reference's scan does;
  * ``grad_dtype='bfloat16'`` rounds the gradients to bf16 before the update
    (the reference's gradient compression; AdamW accumulates in f32);
  * remat is each model's (``layers.ckpt`` around every layer body).

Gradients come from ``torch.autograd.grad`` over the trained leaves, so no
``.grad`` accumulates on the params, and the leaves leave it with the
``requires_grad`` they came with (params a trainer returns serve without
building a graph).  Every GEMM's gradient is two GEMMs through
``ops.matmul`` (the ``repro_torch::gemm`` op's backward): on the card, the
hand-written kernel.

Sharded training: params, moments and batch are DTensors (``dist.sharding``
specs on a ``DeviceMesh``).  The step then computes what the unsharded step
computes on the global batch, as the reference's one ``make_train_step``
partitioned by GSPMD: the loss runs under DTensor's sharding propagation
(every kernel op through its rule, on each rank's local shard), each
gradient is redistributed to its param's placements (the all-reduce or
reduce-scatter GSPMD would insert), the clip's global norm is reduced over
every rank, and the metrics come back as full (replicated) 0-d tensors.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..optim import adamw


def _unflatten(paths: list[str], leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        *parents, last = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _placed_like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor param's gradient in the param's placements."""
    if isinstance(param, DTensor) and tuple(grad.placements) != tuple(param.placements):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def _sharded(params: dict):
    """Implicit replication of plain tensors (positions, masks, constants)
    where the params are DTensors; nothing otherwise."""
    first = next(adamw.trainable(params))[1]
    return implicit_replication() if isinstance(first, DTensor) else contextlib.nullcontext()


def _full(metrics: dict) -> dict:
    return {n: v.full_tensor() if isinstance(v, DTensor) else v for n, v in metrics.items()}


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *, num_microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, state, metrics)``.

    ``params`` are updated in place (and returned); a tied model's
    ``embed_t`` is refreshed from the updated ``embed``.  ``metrics`` hold
    0-d tensors: the model's (``ce_loss``, ``aux_loss`` for a transformer;
    ``ce_loss`` alone with microbatches, as the reference's), ``loss``,
    ``grad_norm`` and ``lr``.  ``train_step.compute_grads(params, batch) ->
    (loss, metrics, grads)`` is the gradient half alone.
    """
    k = num_microbatches

    def grads_of(params: dict, batch: dict):
        paths, leaves = zip(*adamw.trainable(params))
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed_like(g, p) for p, g in zip(leaves, grads)]
        return loss.detach(), {n: v.detach() for n, v in metrics.items()}, list(paths), grads

    def compute_grads(params: dict, batch: dict):
        leaves = [p for _, p in adamw.trainable(params)]
        flags = [p.requires_grad for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with _sharded(params):
                return _compute_grads(params, batch)
        finally:
            for p, flag in zip(leaves, flags):
                p.requires_grad_(flag)

    def _compute_grads(params: dict, batch: dict):
        if k == 1:
            loss, metrics, paths, grads = grads_of(params, batch)
        else:
            micro = {n: a.reshape(k, a.shape[0] // k, *a.shape[1:]) for n, a in batch.items()}
            loss = None
            for i in range(k):
                mb_loss, _, paths, mb_grads = grads_of(params, {n: a[i] for n, a in micro.items()})
                if loss is None:
                    loss, grads = mb_loss.float(), [g.float() for g in mb_grads]
                else:
                    loss = loss + mb_loss
                    for acc, g in zip(grads, mb_grads):
                        acc.add_(g)
            loss = loss / k
            grads = [g / k for g in grads]
            metrics = {"ce_loss": loss}
        if opt_cfg.grad_dtype == "bfloat16":
            grads = [g.to(torch.bfloat16) for g in grads]
        return loss, metrics, _unflatten(paths, grads)

    def train_step(params: dict, opt_state: adamw.AdamWState, batch: dict):
        loss, metrics, grads = compute_grads(params, batch)
        del batch
        with _sharded(params):
            params, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
            emb = params["emb"]
            if "embed_t" in emb:
                with torch.no_grad():
                    emb["embed_t"].copy_(_placed_like(emb["embed"].t(), emb["embed_t"]))
            metrics = _full(dict(metrics, loss=loss, **opt_metrics))
        return params, opt_state, metrics

    train_step.compute_grads = compute_grads
    return train_step
