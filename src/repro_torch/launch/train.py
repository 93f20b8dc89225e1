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

``--fleet`` trains one job over several processes, each started with the
same command and the scheduler's environment (``launch.fleet``:
``REPRO_COORDINATOR``, ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID`` or
SLURM's): the process group (NCCL, one card a process; gloo with ``--device
cpu``, or ``--dist-backend gloo`` for processes that share one card), the
host mesh ``(processes, 1)``, the params and moments sharded on it, and each
process's host shard of the batch.  Every process installs the deployment;
rank 0 writes the checkpoints:

  REPRO_NUM_PROCESSES=2 REPRO_PROCESS_ID=<0|1> REPRO_COORDINATOR=localhost:29511 \
      python -m repro_torch.launch.train --fleet --arch granite-8b --reduced --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import json

import torch

from ..configs import registry
from ..core.runtime import check_compiled, default_runtime
from ..data.pipeline import DataConfig
from ..models.model import build_model
from ..optim import adamw
from ..train.trainer import Trainer, TrainerConfig
from . import fleet
from .mesh import make_host_mesh


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
    ap.add_argument("--fleet", action="store_true",
                    help="multi-process job from the scheduler's environment, state sharded on the host mesh")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="--fleet's process group: nccl on cuda (default), gloo with --device cpu; gloo on cuda "
                         "for processes that share one card")
    args = ap.parse_args(argv)
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

    data = DataConfig(global_batch=args.batch, seq_len=args.seq)
    mesh = None
    if args.fleet:
        if args.device == "cpu" and args.dist_backend == "nccl":
            raise ValueError("--dist-backend nccl needs --device cuda")
        topo = fleet.initialize(backend=args.dist_backend or ("gloo" if args.device == "cpu" else "nccl"))
        if args.device == "cuda":
            torch.cuda.set_device(fleet.local_device_index(topo))
        data = fleet.fleet_data_config(data, topo)
        if topo.is_multihost:
            mesh = make_host_mesh(args.device)
            print(f"process {topo.process_id} of {topo.num_processes}: mesh {tuple(mesh.shape)} "
                  f"{mesh.mesh_dim_names}, backend {torch.distributed.get_backend()}")
    try:
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=args.device)
        opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                             num_microbatches=args.microbatches)
        trainer = Trainer(model, cfg, data, opt, tcfg, mesh=mesh)
        step, _params, _opt, metrics = trainer.train()
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    metrics = {k: float(v) for k, v in metrics.items()}
    print(f"final metrics {json.dumps(metrics)}")
    print(f"finished at step {step}: loss={metrics.get('loss', float('nan')):.4f}")
    return step, metrics


if __name__ == "__main__":
    main()
