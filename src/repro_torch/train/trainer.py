"""Trainer: data + train step + checkpointing + fault tolerance, ported from
``repro/train/trainer.py``.

  * auto-resume from the latest committed checkpoint;
  * async checkpoint every ``ckpt_every`` steps (and a final one), keep-k GC;
  * preemption guard: SIGTERM => checkpoint + clean exit (resumable);
  * straggler detector on per-step wall time;
  * deterministic step-indexed data => exact resume, elastic re-shard.

Runs on the model's device (``build_model(..., device=)``): the weights are
drawn from a generator on that device, seeded with ``seed``, and each batch
is moved there.

With a ``mesh`` (a ``DeviceMesh`` over the group's processes, every process
running the same trainer) the state is sharded as the reference's dry run
shards it: params by ``param_pspecs`` and the moments by ``opt_pspecs``, as
DTensors (each process draws the full init from the seed and keeps its own
shards).  Each data-axis coordinate feeds its own host shard of the batch
(``DataConfig(host_index = data coordinate, host_count = data size)``),
wrapped with ``DTensor.from_local`` by ``batch_pspecs``, so a step's global
batch is the data shards in order and the step computes what the unsharded
step computes on it.  Resume restores onto the placements; checkpoints hold
full arrays written by rank 0.  The straggler detector times each rank's own
steps; a preemption seen by any rank stops every rank at the same step (its
flag is all-reduced each step), so their collective final save matches.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..core.faults import PreemptionGuard, StragglerDetector
from ..data.pipeline import DataConfig, TokenPipeline
from ..dist import sharding as shd
from ..optim import adamw
from .train_step import make_train_step


def data_shard(mesh) -> tuple[int, int]:
    """(host_index, host_count) of this rank's batch shard: its coordinate
    along the mesh's data axes (``pod`` major, then ``data``) and their size."""
    index, count = 0, 1
    for axis in ("pod", "data"):
        if axis in shd.axis_names(mesh):
            size = mesh.size(shd.axis_names(mesh).index(axis))
            index, count = index * size + mesh.get_local_rank(axis), count * size
    return index, count


def global_batch(cfg, data: DataConfig, step: int, hosts: int) -> dict[str, torch.Tensor]:
    """The global batch of a step on ``hosts`` data shards: every shard's
    :meth:`TokenPipeline.batch` concatenated in order (CPU tensors)."""
    parts = [TokenPipeline(cfg, dataclasses.replace(data, host_index=h, host_count=hosts)).batch(step)
             for h in range(hosts)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "build/repro_ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    num_microbatches: int = 1
    dtype: object = torch.float32


class Trainer:
    def __init__(self, model, arch_cfg, data_cfg: DataConfig, opt_cfg=None, tcfg=None, *, mesh=None):
        self.model = model
        self.arch_cfg = arch_cfg
        self.mesh = mesh
        if mesh is not None:
            index, count = data_shard(mesh)
            data_cfg = dataclasses.replace(data_cfg, host_index=index, host_count=count)
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.pipeline = TokenPipeline(arch_cfg, data_cfg)
        self.ckpt = CheckpointManager(self.tcfg.ckpt_dir, keep=self.tcfg.ckpt_keep)
        self.straggler = StragglerDetector()
        self.step_fn = make_train_step(model, self.opt_cfg, num_microbatches=self.tcfg.num_microbatches)
        self.history: list[dict] = []

    # -- state init / resume --------------------------------------------------
    def init_state(self, seed: int = 0):
        params = self.model.init(torch.Generator(device=self.model.device).manual_seed(seed))
        if self.mesh is not None:
            params = shd.distribute_tree(params, shd.param_pspecs(params, self.mesh), self.mesh)
        return params, adamw.init(params)

    def _state_tree(self, params, opt_state):
        return {"params": params, "opt": opt_state._asdict()}

    def _placements(self, params, opt_state):
        """The state tree's ``(mesh, placements)`` pairs, for a restore onto the mesh."""
        p_spec = shd.param_pspecs(params, self.mesh)
        return shd.placement_tree(self._state_tree(p_spec, shd.opt_pspecs(opt_state, p_spec)), self.mesh)

    def resume_or_init(self, seed: int = 0):
        params, opt_state = self.init_state(seed)
        where = None if self.mesh is None else self._placements(params, opt_state)
        got = self.ckpt.restore_latest(self._state_tree(params, opt_state), placements=where)
        if got is None:
            return 0, params, opt_state
        step, tree, _extra = got
        return step, tree["params"], adamw.AdamWState(**tree["opt"])

    def _batch(self, step: int) -> dict:
        batch = self.pipeline.device_batch(step, dtype=self.tcfg.dtype, device=self.model.device)
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import DTensor

        specs = shd.batch_pspecs(batch, self.mesh)
        return {k: DTensor.from_local(v, self.mesh, shd.placements(specs[k], self.mesh), run_check=False)
                for k, v in batch.items()}

    def _preempted(self, guard) -> bool:
        """The guard's flag; with a mesh, whether any rank's guard fired."""
        if self.mesh is None:
            return guard.preempted
        import torch.distributed as dist

        flag = torch.tensor([int(guard.preempted)], device=self.model.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    # -- loop -------------------------------------------------------------------
    def train(self, *, seed: int = 0, stop_after: int | None = None):
        """Run to total_steps (or stop_after more steps); returns (step,
        params, opt_state, final metrics)."""
        start, params, opt_state = self.resume_or_init(seed)
        end = self.tcfg.total_steps if stop_after is None else min(self.tcfg.total_steps, start + stop_after)
        metrics = {}
        device = self.model.device
        with PreemptionGuard() as guard:
            for step in range(start, end):
                self.straggler.start()
                batch = self._batch(step)
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # the step's wall time, for the straggler detector
                if self.straggler.stop():
                    print(f"[ft] straggler step {step}: {self.straggler.times[-1]:.2f}s")
                if (step + 1) % self.tcfg.log_every == 0 or step + 1 == end:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step + 1
                    self.history.append(m)
                    print(f"step {step + 1}/{self.tcfg.total_steps} loss={m.get('loss', float('nan')):.4f} "
                          f"gnorm={m.get('grad_norm', float('nan')):.2f}", flush=True)
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save_async(step + 1, self._state_tree(params, opt_state))
                if self._preempted(guard):
                    print(f"[ft] preemption at step {step + 1}: checkpointing and exiting")
                    self.ckpt.wait()
                    self.ckpt.save(step + 1, self._state_tree(params, opt_state))
                    return step + 1, params, opt_state, metrics
        self.ckpt.wait()
        self.ckpt.save(end, self._state_tree(params, opt_state))
        print(f"[{time.strftime('%H:%M:%S')}] training done at step {end}")
        return end, params, opt_state, metrics
