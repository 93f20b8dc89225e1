"""Child processes of ``tests/test_torch_dist.py``: gloo jobs on the CPU that
import only ``repro_torch``.

  python tests/_torch_dist_jobs.py <work dir> <mesh, e.g. 2x1> <rank> <restore-from mesh or "">

Every rank joins a gloo group through a ``FileStore`` in the work dir and
builds a ``("data", "model")`` mesh.  For each arch of ``<work>/job.json`` it
loads the numpy params the test wrote (``<work>/<arch>.params.npz``, the
reference's init carried across by ``repro_torch.weights``), shards params,
moments and its host shard of each step's batch as the dry run shards them,
takes the steps (counting the last one's collectives), and rank 0 writes
the metrics and gathered params to
``<work>/<arch>.<mesh>.npz``; every rank then saves the final state as a
checkpoint under ``<work>/ckpt.<arch>.<mesh>``.  The four-process job runs its
all-gathers through ``fleet.route_all_gather_through_c10d``.  With a restore-from mesh,
each rank also restores that mesh's checkpoint onto this mesh's placements and
rank 0 writes the gathered leaves to ``<work>/<arch>.restored.<mesh>.npz``.

An arch entry names its config (``arch``), depth and, for an MoE variant, a
``capacity_factor``.  For an MoE entry every rank also holds ``moe_ffn`` on
layer 0's params against the unsharded function on the global input (seeded
numpy x and output weights), as the buffers are constrained by default, with
``moe_cap_data`` and with ``seq_model``'s activations: output, aux loss, the
gradients of x and of the params, its own tokens' kept mask against the
unsharded mask's rows, and the dispatch buffer's local shape; it
writes ``<work>/<arch>.moe.<mesh>.<rank>.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import fleet
from repro_torch.launch.commanalysis import CollectiveCounter
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.weights import params_from_jax


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        *parents, last = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = arr
    return out


def _gathered(tree) -> dict:
    return {p: t.detach().numpy() for p, t in adamw.trainable(shd.gather_tree(tree))}


def job_cfg(spec: dict):
    cfg = dataclasses.replace(registry.get(spec["arch"]).reduced(), n_layers=spec["n_layers"])
    if spec.get("capacity_factor") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=spec["capacity_factor"]))
    return cfg


# moe_ffn's variants: (buffer constraint, activation constraint)
MOE_VARIANTS = {"default": ((None, None), (None, None)), "moe_cap_data": (("model", "data"), (None, None)),
                "seq_model": ((None, None), (("data",), "model"))}


def check_moe(cfg, params: dict, mesh, seed: int = 5) -> dict:
    """``moe_ffn`` on layer 0's params, sharded under each variant, against the unsharded function."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    layer = {k: v[0].detach().clone() for k, v in params["blocks"]["moe"].items()}
    ref_p = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
    ref_x = x.clone().requires_grad_(True)
    out, aux = moe.moe_ffn(ref_p, ref_x, cfg)
    ((out * w).sum() + 3.0 * aux).backward()
    ref = moe.route(layer, x, cfg)
    data, model = mesh.get_coordinate()
    rows = x.shape[0] // mesh.size(0) * x.shape[1] * cfg.moe.top_k  # this data rank's assignments
    block = slice(data * rows, (data + 1) * rows)
    # The same tokens routed on their own: capacity and slots from the local tokens alone.
    alone = moe.route(layer, x[data * (x.shape[0] // mesh.size(0)):(data + 1) * (x.shape[0] // mesh.size(0))], cfg)
    result = {"rank": dist.get_rank(), "coordinate": [data, model], "capacity": ref.capacity,
              "dropped": int((~ref.keep).sum()), "alone_differs": bool(not torch.equal(alone.keep, ref.keep[block]))}
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    for name, (buf_axes, act_axes) in MOE_VARIANTS.items():
        shapes = []
        constrain = L.shard_moe_buf

        def recording(t, constrain=constrain, shapes=shapes):
            t = constrain(t)
            shapes.append(list(t.to_local().shape))
            return t

        L.set_moe_sharding(*buf_axes)
        L.set_activation_sharding(*act_axes)
        L.shard_moe_buf = recording
        try:
            p_spec = shd.param_pspecs(params["blocks"]["moe"], mesh)
            dp = {k: v[0].detach() for k, v in shd.distribute_tree(params["blocks"]["moe"], p_spec, mesh).items()}
            dp = {k: v.requires_grad_(True) for k, v in dp.items()}
            dx = L.shard_act(shd.distribute_tree({"x": x}, shd.batch_pspecs({"x": x}, mesh), mesh)["x"])
            dx = dx.detach().requires_grad_(True)
            dw = shd.distribute_tree({"w": w}, shd.batch_pspecs({"w": w}, mesh), mesh)["w"]
            counter = CollectiveCounter()
            with counter:
                got, got_aux = moe.moe_ffn(dp, dx, cfg)
                ((got * dw).sum() + 3.0 * got_aux).backward()
            route = moe.route(dp, dx, cfg)
            errs = {"out": rel(got.full_tensor(), out), "aux": rel(got_aux.full_tensor(), aux),
                    "grad x": rel(dx.grad.full_tensor(), ref_x.grad)}
            errs |= {f"grad {k}": rel(v.grad.full_tensor(), ref_p[k].grad) for k, v in dp.items()}
        finally:
            L.shard_moe_buf = constrain
            L.set_moe_sharding(None, None)
            L.set_activation_sharding(None, None)
        result[name] = {"errors": errs, "keep_equal": bool(torch.equal(route.keep, ref.keep[block])),
                        "buffer_shapes": shapes, "x_placements": [str(p) for p in dx.placements],
                        "collectives": counter.summary()}
    return result


def run_arch(job: dict, arch: str, work: Path, mesh, tag: str, restore_from: str) -> None:
    spec = job["archs"][arch]
    cfg = job_cfg(spec)
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    with np.load(work / f"{arch}.params.npz") as z:
        params = params_from_jax(_unflatten(dict(z)), cfg, device="cpu", dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig(**job["opt"])
    tcfg = TrainerConfig(total_steps=job["steps"], ckpt_dir=str(work / f"ckpt.{arch}.{tag}"))
    trainer = Trainer(model, cfg, DataConfig(global_batch=job["batch"], seq_len=job["seq"]), opt_cfg, tcfg,
                      mesh=mesh)
    if cfg.moe is not None:
        (work / f"{arch}.moe.{tag}.{dist.get_rank()}.json").write_text(json.dumps(check_moe(cfg, params, mesh)))
    p_spec = shd.param_pspecs(params, mesh)
    params = shd.distribute_tree(params, p_spec, mesh)
    opt = adamw.init(params)
    step_fn = make_train_step(model, opt_cfg)
    metrics = []
    counter = CollectiveCounter()  # the last step's collectives
    for step in range(job["steps"]):
        with counter if step == job["steps"] - 1 else contextlib.nullcontext():
            params, opt, met = step_fn(params, opt, trainer._batch(step))
        metrics.append({k: float(v) for k, v in met.items()})
    local = {p: tuple(t.to_local().shape) for p, t in adamw.trainable(params) if isinstance(t, DTensor)}
    out = _gathered(params)
    if dist.get_rank() == 0:
        np.savez(work / f"{arch}.{tag}.npz", **out)
        (work / f"{arch}.{tag}.json").write_text(json.dumps({
            "metrics": metrics, "local_shapes": local,
            "data_shard": [trainer.pipeline.data.host_index, trainer.pipeline.data.host_count],
            "collectives_last_step": counter.summary(),
            "placements": {p: [str(x) for x in t.placements] for p, t in adamw.trainable(params)}}))
    trainer.ckpt.save(job["steps"], trainer._state_tree(params, opt))
    if restore_from:
        source = CheckpointManager(work / f"ckpt.{arch}.{restore_from}")
        where = trainer._placements(params, opt)
        tree, _ = source.restore(job["steps"], trainer._state_tree(params, opt), placements=where)
        restored = {f"params/{p}": a for p, a in _gathered(tree["params"]).items()}
        restored |= {f"opt/m/{p}": a for p, a in _gathered(tree["opt"]["m"]).items()}
        if dist.get_rank() == 0:
            np.savez(work / f"{arch}.restored.{tag}.npz", **restored)


def main(argv: list[str]) -> None:
    work, tag, rank, restore_from = Path(argv[0]), argv[1], int(argv[2]), argv[3]
    shape = tuple(int(n) for n in tag.split("x"))
    world = shape[0] * shape[1]
    torch.set_num_threads(2)
    if world == 4:  # the route 26b's one-card gloo group takes for CUDA tensors, here on the CPU
        fleet.route_all_gather_through_c10d("CPU")
    dist.init_process_group("gloo", store=dist.FileStore(str(work / f"store.{tag}"), world), rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        job = json.loads((work / "job.json").read_text())
        for arch in job["archs"]:
            run_arch(job, arch, work, mesh, tag, restore_from)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
