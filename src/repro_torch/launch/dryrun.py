"""Multi-pod dry run, ported from ``repro/launch/dryrun.py``: every (arch x
shape x mesh) cell on the production mesh, without a card.

The reference lowers and compiles each cell on 512 placeholder CPU devices.
The port has no compiler to ask: it runs each cell's program on a **fake
process group** of 256 (``single``: (16, 16) as ``("data", "model")``) or
512 ranks (``multi``: (2, 16, 16) as ``("pod", "data", "model")``), as rank 0,
on **meta tensors**: params, AdamW moments, batch and cache are DTensors
placed by ``dist.sharding`` (the reference's specs), every kernel op runs
through its sharding rule and its fake impl, and the collectives DTensor
issues return at once.  Nothing is allocated and nothing is timed: every
number in a record is reckoned from shapes, per device (rank 0's local
shards), never measured.

Each record has the reference's keys where they mean the same thing:

  * ``arch``, ``shape``, ``mesh``, ``opts``, ``devices``; ``run_s``, the
    seconds the CPU took to run the cell (in place of ``lower_s`` /
    ``compile_s``);
  * ``flops``: ``torch.utils.flop_counter``'s formulas (FlopCounterMode's
    registry, plus one for each kernel op) summed over the local ops;
  * ``bytes_accessed`` (the port's definition): the bytes each local op
    reads and writes, its tensor operands and results each counted once per
    op, no fusion assumed; views, allocations and collectives move none;
  * ``argument_bytes``: the local bytes of params, optimizer state, batch and
    cache; ``output_bytes``: of what the cell returns (a train step returns
    the updated params and moments: ``alias_bytes`` of them are its
    arguments, updated in place);
  * ``temp_bytes``: the peak of the local tensors alive during the cell
    (``torch.distributed._tools.mem_tracker.MemTracker``, seeing the local
    ops), less the arguments;
  * ``collectives``: ``commanalysis.CollectiveCounter``'s counts and bytes.

Depth is probed, not run whole: a cell runs at two depths of its model's
repeating unit (one and two layers; a VLM's layer groups; Hymba at 4 and 5
layers, so its first, middle and last global layers stay put; an
encoder-decoder's encoder and decoder layers in turn) and every number is
extrapolated linearly to the config's depth (``probe_depths`` in the
record).  The units are identical, so the reckoning is exact for counts,
FLOPs and bytes; ``temp_bytes`` assumes the peak grows by the same amount
each layer.

Options (``--opt``, the reference's, set as its ``build_cell`` sets them):

  * ``grad_bf16``: gradients rounded to bf16 before the update;
  * ``micro4``: 4-way microbatch gradient accumulation;
  * ``remat_dots``: remat "dots" (GEMM outputs kept) instead of "full";
  * ``kv_int8``: an int8 KV cache (dense, MoE and VLM archs);
  * ``seq_model``: sequence parallelism, train and prefill cells other than
    long_500k: activations split their batch over the data axes and their
    sequence over ``model`` between blocks
    (``layers.set_activation_sharding(dp, "model")``);
  * ``cache_seq_model``: context-parallel decode: the KV cache's sequence
    dim over ``model`` (``cache_pspecs(kv_seq_axis="model")``).
    ``cache_pspecs`` reads the axis only where it splits the sequence
    (``shard_seq``), so this changes only long_500k cells with a KV cache,
    which means hymba-1.5b's;
  * ``moe_cap_data``: the MoE dispatch and expert buffers split experts over
    ``model`` and capacity over ``data`` (``layers.set_moe_sharding("model",
    "data")``), so the data ranks' slots are reduce-scattered along C, not
    all-reduced.

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh both]
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ..configs import registry
from ..dist import sharding as shd
from ..models import layers as L
from ..models.model import build_model
from ..optim import adamw
from ..train.train_step import make_train_step
from .commanalysis import CollectiveCounter, collective_kind, local_call
from .mesh import make_production_mesh, production_mesh_shape

OPTIONS = ("grad_bf16", "micro4", "remat_dots", "kv_int8", "seq_model", "cache_seq_model", "moe_cap_data")


# ---------------------------------------------------------------------------
# FLOP formulas for the kernel ops (the GEMM's as aten.mm's; the recurrences'
# from their plain algorithms: a state update and a readout per step)
# ---------------------------------------------------------------------------
_KERNEL_OPS = torch.ops.repro_torch


@register_flop_formula(_KERNEL_OPS.gemm)
def _gemm_flops(lhs_shape, rhs_shape, *args, **kwargs) -> int:
    m = 1
    for d in lhs_shape[:-1]:
        m *= d
    return 2 * m * lhs_shape[-1] * rhs_shape[1]


@register_flop_formula([_KERNEL_OPS.wkv, _KERNEL_OPS.wkv_backward])
def _wkv_flops(r_shape, *args, **kwargs) -> int:
    b, s, h, hd = r_shape
    return 6 * b * s * h * hd * hd


@register_flop_formula([_KERNEL_OPS.ssm_scan, _KERNEL_OPS.ssm_scan_backward])
def _scan_flops(dtx_shape, dta_shape, *args, **kwargs) -> int:
    return 6 * dta_shape[0] * dta_shape[1] * dta_shape[2] * dta_shape[3]


@register_flop_formula([_KERNEL_OPS.ssm_scan_fused, _KERNEL_OPS.ssm_scan_fused_backward])
def _fused_scan_flops(x_shape, dt_shape, a_shape, *args, **kwargs) -> int:
    return 6 * x_shape[0] * x_shape[1] * x_shape[2] * a_shape[1]


class LocalCost(TorchDispatchMode):
    """FLOPs and bytes accessed of the local ops (each rank's shards) beneath DTensor."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.last_dtensor_op = None  # the op a failing cell stopped in

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.last_dtensor_op = func
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not local_call(types) or collective_kind(func) is not None:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and not func.__name__.startswith(("empty", "new_empty", "detach")):
            self.bytes += _nbytes(args) + _nbytes(kwargs.values()) + _nbytes(out)
        return out


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)) or type(tree).__name__ == "dict_values":
        return sum(_nbytes(t) for t in tree)
    return 0


def _local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    return _nbytes(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_mem_tracker():
    """A ``MemTracker`` that sees the local ops beneath DTensor (not the DTensor calls)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


# ---------------------------------------------------------------------------
# the fake group and the mesh
# ---------------------------------------------------------------------------
def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake group of ``world`` ranks (collectives return at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(kind: str):
    shape, _ = production_mesh_shape(multi_pod=kind == "multi")
    world = 1
    for n in shape:
        world *= n
    fake_group(world)
    return make_production_mesh(multi_pod=kind == "multi", device_type="cpu")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def check_opts(opts) -> frozenset:
    opts = frozenset(opts)
    unknown = sorted(opts - set(OPTIONS))
    if unknown:
        raise ValueError(f"unknown --opt {unknown}; known: {list(OPTIONS)}")
    return opts


def _distribute(tree, specs, mesh):
    return shd.distribute_tree(tree, specs, mesh)


def build_cell(cfg, shape: str, mesh, opts: frozenset):
    """(run, arguments) of one cell: ``run()`` executes the cell's program on the
    DTensor arguments and returns its outputs."""
    from torch.distributed.tensor.experimental import implicit_replication

    sp = registry.SHAPES[shape]
    kv_quant = "kv_int8" in opts and cfg.family in ("dense", "moe", "vlm")
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="meta", kv_quant=kv_quant)
    shard_seq = shape == "long_500k"
    params = model.init()
    p_spec = shd.param_pspecs(params, mesh)
    dparams = _distribute(params, p_spec, mesh)
    inputs = registry.input_specs(cfg.name, shape)

    if sp.kind == "train":
        opt = adamw.init(dparams)
        batch = _distribute(inputs, shd.batch_pspecs(inputs, mesh), mesh)
        opt_cfg = adamw.AdamWConfig(grad_dtype="bfloat16" if "grad_bf16" in opts else "float32")
        step = make_train_step(model, opt_cfg, num_microbatches=4 if "micro4" in opts else 1)

        def run():
            with implicit_replication():
                return step(dparams, opt, batch)

        return run, (dparams, opt, batch)

    if sp.kind == "prefill":
        batch = _distribute(inputs, shd.batch_pspecs(inputs, mesh), mesh)

        def run():
            with torch.no_grad(), implicit_replication():
                return model.prefill(dparams, batch, sp.seq_len)

        return run, (dparams, batch)

    # decode: one token against a full-length cache
    b = sp.global_batch
    cache = model.init_cache(b, sp.seq_len)
    if cfg.family == "audio":  # the decoder needs the encoder memory
        cache["memory"] = torch.empty((b, sp.seq_len, cfg.d_model), dtype=torch.bfloat16, device="meta")
    kv_seq_axis = "model" if "cache_seq_model" in opts else None
    dcache = _distribute(cache, shd.cache_pspecs(cache, mesh, shard_seq=shard_seq, kv_seq_axis=kv_seq_axis), mesh)
    toks = {"tokens": inputs["tokens"], "positions": inputs["positions"]}
    t_spec = ({k: shd.P(*([None] * v.ndim)) for k, v in toks.items()} if shard_seq
              else shd.batch_pspecs(toks, mesh))
    dtoks = _distribute(toks, t_spec, mesh)

    def run():
        with torch.no_grad(), implicit_replication():
            return model.decode_step(dparams, dcache, dtoks["tokens"], dtoks["positions"])

    return run, (dparams, dcache, dtoks)


def probes(cfg) -> tuple[list, list[float], list]:
    """(probe configs, weights, depths): the cell's numbers at the config's
    depth are ``sum(w * numbers(probe))`` (linear in the count of each
    repeating unit)."""
    if cfg.family == "audio":
        e, d = cfg.n_enc_layers, cfg.n_layers
        cfgs = [dataclasses.replace(cfg, n_enc_layers=a, n_layers=b) for a, b in ((1, 1), (2, 1), (1, 2))]
        return cfgs, [1.0 - (e - 1) - (d - 1), float(e - 1), float(d - 1)], [(1, 1), (2, 1), (1, 2)]
    if cfg.family == "vlm":
        unit, base = cfg.cross_every, 1
    elif cfg.family == "hybrid":  # layers 0, n // 2 and n - 1 are global at 4 and 5 as at 32
        unit, base = 1, 4
    else:
        unit, base = 1, 1
    units = cfg.n_layers // unit
    depths = [base * unit, (base + 1) * unit]
    cfgs = [dataclasses.replace(cfg, n_layers=n) for n in depths]
    return cfgs, [float(base + 1 - units), float(units - base)], depths


def _measure(cfg, shape: str, mesh, opts: frozenset) -> dict:
    """One probe: run the cell under the cost, collective and memory modes."""
    run, args = build_cell(cfg, shape, mesh, opts)
    arg_bytes = _local_bytes(args)
    arg_ids = {id(t) for t in _leaves(args)}
    cost, comms, mem = LocalCost(), CollectiveCounter(), _local_mem_tracker()
    from torch.distributed.tensor import DTensor

    locals_ = [t.to_local() if isinstance(t, DTensor) else t for t in _leaves(args)]
    mem.track_external(*locals_)
    with mem:
        start = mem.get_tracker_snapshot("current")
        with comms, cost:
            try:
                out = run()
            except Exception as e:  # name the DTensor op it stopped in: the op without a rule
                raise RuntimeError(f"{e!r} in {cost.last_dtensor_op} under DTensor") from e
        peak = mem.get_tracker_snapshot("peak")
    total = lambda snap: sum(v["Total"] for v in snap.values())
    out_leaves = _leaves(out)
    return {"flops": float(cost.flops), "bytes_accessed": float(cost.bytes), "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out_leaves),
            "alias_bytes": _local_bytes([t for t in out_leaves if id(t) in arg_ids]),
            "temp_bytes": total(peak) - total(start), "collectives": comms.summary()}


def _combine(parts: list[dict], weights: list[float]) -> dict:
    out: dict = {}
    for key in ("flops", "bytes_accessed", "output_bytes", "alias_bytes", "temp_bytes"):
        out[key] = sum(w * p[key] for p, w in zip(parts, weights))
    colls: dict = {}
    for p, w in zip(parts, weights):
        for k, v in p["collectives"].items():
            colls[k] = colls.get(k, 0) + w * v
    out["collectives"] = {k: (int(round(v)) if k.endswith("_count") else float(v)) for k, v in colls.items()}
    for key in ("output_bytes", "alias_bytes", "temp_bytes"):
        out[key] = int(round(out[key]))
    return out


def argument_bytes(cfg, shape: str, mesh, opts: frozenset) -> int:
    """The local bytes of the cell's arguments at the config's full depth (from shapes alone)."""
    _, args = build_cell(cfg, shape, mesh, opts)
    return _local_bytes(args)


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path | None, opts: frozenset = frozenset(), *,
             n_layers: int | None = None) -> dict:
    """One cell's record (written to ``out_dir`` when given); ``n_layers``
    cuts the arch's depth (the tests' reduced-depth cells)."""
    opts = check_opts(opts)
    cfg = registry.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = production_mesh(mesh_kind)
    shard_seq = shape == "long_500k"
    t0 = time.time()
    try:
        if "seq_model" in opts and not shard_seq and registry.SHAPES[shape].kind in ("train", "prefill"):
            dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
            L.set_activation_sharding(batch_axes=dp, seq_axes="model")
        else:  # batch over the data axes (unset), or long_500k's sequence over data
            L.set_activation_sharding(batch_axes=None, seq_axes="data" if shard_seq else None)
        L.set_remat_policy("dots" if "remat_dots" in opts else "full")
        if "moe_cap_data" in opts:
            L.set_moe_sharding(ep_axes="model", cap_axes="data")
        cfgs, weights, depths = probes(cfg)
        # The first run of an op's shapes in a process also counts ops DTensor runs while it
        # works out their sharding (hymba-1.5b's train_4k: 46% more bytes at 4 layers); a
        # warm-up run of the first probe keeps them out.
        _measure(cfgs[0], shape, mesh, opts)
        parts = [_measure(c, shape, mesh, opts) for c in cfgs]
        record = _combine(parts, weights)
        record["argument_bytes"] = argument_bytes(cfg, shape, mesh, opts)
    finally:
        L.set_activation_sharding(None, None)
        L.set_remat_policy("full")
        L.set_moe_sharding(None, None)
    record = {"arch": arch, "shape": shape, "mesh": mesh_kind, "opts": sorted(opts), "devices": int(mesh.size()),
              "run_s": round(time.time() - t0, 2), "n_layers": cfg.n_layers, "probe_depths": depths, **record,
              "reckoned": "from shapes on meta tensors; no time or memory was measured"}
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = ("@" + "+".join(sorted(opts))) if opts else ""
        (out_dir / f"{arch}__{shape}__{mesh_kind}{suffix}.json").write_text(json.dumps(record, indent=1))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--opt", default="", help=f"comma-separated options: {', '.join(OPTIONS)}")
    ap.add_argument("--skip-existing", action="store_true", help="skip cells with a record")
    args = ap.parse_args(argv)

    opts = check_opts(o for o in args.opt.split(",") if o)
    out_dir = Path(args.out)
    cells = registry.all_cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    suffix = ("@" + "+".join(sorted(opts))) if opts else ""
    for arch, shape in cells:
        for mk in meshes:
            tag = f"{arch} x {shape} x {mk}"
            if args.skip_existing and (out_dir / f"{arch}__{shape}__{mk}{suffix}.json").exists():
                print(f"SKIP-EXISTING {tag}")
                continue
            try:
                rec = run_cell(arch, shape, mk, out_dir, opts)
                per_dev_gb = (rec["argument_bytes"] + rec["temp_bytes"]) / 2**30
                print(f"PASS {tag}: run={rec['run_s']}s flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                      f"arg+temp/dev={per_dev_gb:.2f}GiB "
                      f"colls={ {k: v for k, v in rec['collectives'].items() if k.endswith('_count')} }", flush=True)
            except Exception as e:  # noqa: BLE001 — a failing cell is a finding to surface, not to hide
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e!r}", flush=True)
    for skip in registry.skipped_cells():
        print(f"SKIP {skip[0]} x {skip[1]}: {skip[2]}")
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {[f[0] for f in failures]}")


if __name__ == "__main__":
    main()
