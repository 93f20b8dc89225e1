"""Training launcher, ported from ``repro/launch/train.py``:
``python -m repro_torch.launch.train --arch <id> [...]``.

Runs a real (reduced or full) training job on ``cuda`` unless ``--device
cpu``, with a tuned kernel deployment installed into the process default
runtime (``--deployment``), checkpointing with auto-resume, and the
fault-tolerance runtime active.  The model trains in f32, as the
reference's launcher does; weights come from a generator on the device,
seeded with 0.  On the card every GEMM, the forward's and both gradient
GEMMs, runs the deployment's selected config of the hand-written kernel, and
so do RWKV6's WKV and Hymba's selective scan, forward and backward kernel:

  python -m repro_torch.launch.train --arch granite-8b --reduced --steps 4 --batch 2 --seq 16 \\
      --ckpt-every 2 --deployment build/deploy_h100.json
  python -m repro_torch.launch.train --arch rwkv6-7b --reduced --steps 4 --batch 2 --seq 16

``--fleet`` (multi-host) waits for the distribution slice.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import registry
from ..core.runtime import check_compiled, default_runtime
from ..data.pipeline import DataConfig
from ..models.model import build_model
from ..optim import adamw
from ..train.trainer import Trainer, TrainerConfig

FLEET_REFUSED = ("--fleet: multi-host training waits for the distribution slice of the port "
                 "(torch.distributed process groups, sharded params and optimizer state)")


def main(argv=None):
    """Train; returns (final step, final metrics as floats)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--deployment", default=None, help="tuned kernel deployment JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fleet", action="store_true", help="multi-host (not ported yet: raises)")
    args = ap.parse_args(argv)
    if args.fleet:
        raise NotImplementedError(FLEET_REFUSED)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch finds no CUDA device; pass --device cpu to train on the CPU "
                           "with the kernels' plain versions")

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    if args.deployment:
        from ..core.dispatch import Deployment

        # Training dispatch runs on the process default runtime (the trainer
        # owns every thread here, so an isolated handle buys nothing).
        deployment = Deployment.load(args.deployment)
        check_compiled(deployment, args.device, deployment.device)
        default_runtime().install(deployment)
        print(f"installed kernel deployment from {args.deployment}")

    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=args.device)
    data = DataConfig(global_batch=args.batch, seq_len=args.seq)
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                         num_microbatches=args.microbatches)
    trainer = Trainer(model, cfg, data, opt, tcfg)
    step, _params, _opt, metrics = trainer.train()
    metrics = {k: float(v) for k, v in metrics.items()}
    print(f"finished at step {step}: loss={metrics.get('loss', float('nan')):.4f}")
    return step, metrics


if __name__ == "__main__":
    main()
