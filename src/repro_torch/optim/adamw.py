"""AdamW with global-norm clipping and a cosine LR schedule, ported from
``repro/optim/adamw.py``.

Moments are kept in f32 whatever the param dtype.  The port updates params
and moments in place under ``torch.no_grad()`` (the reference returns new
trees), one leaf at a time, so the temporaries never exceed a few copies of
the largest leaf (the vocab matrices).  Every scalar (the step, the learning
rate, the clip scale, the bias corrections) stays a 0-d tensor on the
params' device: an update reads nothing back to the host.

Params are the model's tree of tensors; ``emb.embed_t``, a tied model's
load-time copy of ``embed.T``, is derived, not trained (:func:`trainable`).
Sharded params are DTensors (``dist.sharding``): the moments then carry the
params' placements, each gradient arrives in its param's placements (the
train step redistributes it), and the global norm's sum of squares is
reduced over every rank by DTensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # gradient compression: 'bfloat16' rounds the gradients before the update
    grad_dtype: str = "float32"  # 'float32' | 'bfloat16'


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: dict
    v: dict


DERIVED = ("embed_t",)  # leaves computed from others, never trained or saved


def trainable(tree: dict, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(path, leaf) of every trained leaf, in the reference's tree order
    (dict keys sorted), paths joined with ``/`` as its checkpoints key them."""
    for key in sorted(tree):
        if key in DERIVED:
            continue
        value = tree[key]
        if isinstance(value, dict):
            yield from trainable(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def like_tree(tree: dict, fn) -> dict:
    """``tree``'s structure without derived leaves, each trained leaf mapped through ``fn``."""
    return {k: like_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items() if k not in DERIVED}


def init(params: dict) -> AdamWState:
    """Zero moments in f32 beside each param (a DTensor param's with its
    placements), and step 0 (replicated over a DTensor param's mesh)."""
    first = next(trainable(params))[1]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return AdamWState(step=step, m=like_tree(params, zeros), v=like_tree(params, zeros))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_ratio * lr`` (0-d f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each leaf summed in f32."""
    sq = [torch.sum(g.float() ** 2) for _, g in trainable(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict):
    """One AdamW step, in place on ``params`` and the state's moments.

    Returns (params, new state, {"grad_norm", "lr"}), as the reference's.
    """
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.betas
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, stepf), 1 - torch.pow(b2, stepf)
    g_leaves, m_leaves, v_leaves = (dict(trainable(t)) for t in (grads, state.m, state.v))
    for path, p in trainable(params):
        m, v = m_leaves[path], v_leaves[path]
        g = g_leaves[path].float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        p32 = p.float()  # p itself when f32
        delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
