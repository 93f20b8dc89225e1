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
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..core.faults import PreemptionGuard, StragglerDetector
from ..data.pipeline import DataConfig, TokenPipeline
from ..optim import adamw
from .train_step import make_train_step


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
    def __init__(self, model, arch_cfg, data_cfg: DataConfig, opt_cfg=None, tcfg=None):
        self.model = model
        self.arch_cfg = arch_cfg
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
        return params, adamw.init(params)

    def _state_tree(self, params, opt_state):
        return {"params": params, "opt": opt_state._asdict()}

    def resume_or_init(self, seed: int = 0):
        params, opt_state = self.init_state(seed)
        got = self.ckpt.restore_latest(self._state_tree(params, opt_state))
        if got is None:
            return 0, params, opt_state
        step, tree, _extra = got
        return step, tree["params"], adamw.AdamWState(**tree["opt"])

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
                batch = self.pipeline.device_batch(step, dtype=self.tcfg.dtype, device=device)
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
                if guard.preempted:
                    print(f"[ft] preemption at step {step + 1}: checkpointing and exiting")
                    self.ckpt.wait()
                    self.ckpt.save(step + 1, self._state_tree(params, opt_state))
                    return step + 1, params, opt_state, metrics
        self.ckpt.wait()
        self.ckpt.save(end, self._state_tree(params, opt_state))
        print(f"[{time.strftime('%H:%M:%S')}] training done at step {end}")
        return end, params, opt_state, metrics
