"""The port's dry run (``launch/dryrun.py``) and roofline (``launch/roofline.py``).

  * one full-width cell a family at reduced depth on the fake 256-rank
    (16, 16) mesh: granite-8b's train step (dense), rwkv6-7b's decode step
    (ssm), hymba-1.5b's decode step (hybrid); each record has the
    reference's keys, finite non-negative numbers, and collectives where
    params are FSDP-sharded;
  * ``argument_bytes`` equals the local bytes reckoned from the reference's
    own ``param_pspecs`` / ``opt_pspecs`` / ``batch_pspecs`` and shapes
    (``jax.eval_shape``), each sharded dim divided as JAX divides it;
  * probing two depths extrapolates exactly: a 3-layer cell from probes at
    1 and 2 layers equals the 3-layer cell itself (counts, FLOPs, bytes);
  * the MoE archs' cells, qwen3-moe-235b-a22b's train step and dbrx-132b's
    decode step at reduced depth, and each of the reference's constraint
    options on one cell (``seq_model``, ``cache_seq_model``,
    ``moe_cap_data``): accepted, recorded in ``opts``, ``argument_bytes`` equal
    to the reference's specs (with ``kv_seq_axis="model"`` for
    ``cache_seq_model``); under ``moe_cap_data`` the expert work is split over
    data, so the cell's FLOPs fall;
  * a failing cell prints ``FAIL`` and exits nonzero, as the reference's;
  * the roofline over synthetic records, with the H100's constants.
"""
import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import registry as jax_registry
from repro.dist import sharding as jax_shd
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.configs import registry
from repro_torch.launch import dryrun, roofline

KEYS = {"arch", "shape", "mesh", "opts", "devices", "run_s", "flops", "bytes_accessed", "argument_bytes",
        "output_bytes", "temp_bytes", "alias_bytes", "collectives", "n_layers", "probe_depths", "reckoned"}
MESH = {"data": 16, "model": 16}


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


CELLS = {"dense": ("granite-8b", "train_4k", 2), "ssm": ("rwkv6-7b", "decode_32k", 2),
         "hybrid": ("hymba-1.5b", "decode_32k", 5)}


@pytest.fixture(scope="module")
def records():
    return {fam: dryrun.run_cell(arch, shape, "single", None, n_layers=n) for fam, (arch, shape, n) in CELLS.items()}


@pytest.mark.parametrize("family", list(CELLS))
def test_cell_record(records, family):
    arch, shape, n = CELLS[family]
    rec = records[family]
    assert set(rec) == KEYS
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"], rec["n_layers"]) == (arch, shape, "single", 256, n)
    for key in ("flops", "bytes_accessed", "argument_bytes", "output_bytes", "temp_bytes"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["alias_bytes"] <= rec["output_bytes"]
    json.dumps(rec)
    # Params FSDP-sharded over data: every step gathers them.
    assert rec["collectives"].get("all-gather_count", 0) > 0 and rec["collectives"]["all-gather_bytes"] > 0
    if registry.SHAPES[shape].kind == "train":
        # the gradients go back to their shards: reduce-scatters; the train step updates params in place
        assert rec["collectives"].get("reduce-scatter_count", 0) > 0
        assert rec["alias_bytes"] > 0


MOE_CELLS = {"qwen3-moe-235b-a22b": ("train_4k", 2), "dbrx-132b": ("decode_32k", 2)}
# option -> the cell it runs on (arch, shape, n_layers)
OPTION_CELLS = {"seq_model": ("granite-8b", "train_4k", 2), "cache_seq_model": ("hymba-1.5b", "long_500k", 5),
                "moe_cap_data": ("dbrx-132b", "decode_32k", 2)}


@pytest.fixture(scope="module")
def moe_records():
    return {arch: dryrun.run_cell(arch, shape, "single", None, n_layers=n) for arch, (shape, n) in MOE_CELLS.items()}


@pytest.fixture(scope="module")
def option_records():
    return {opt: dryrun.run_cell(arch, shape, "single", None, frozenset({opt}), n_layers=n)
            for opt, (arch, shape, n) in OPTION_CELLS.items()}


def _ref_local_bytes(spec, shape, itemsize) -> int:
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = entry if isinstance(entry, tuple) else ((entry,) if entry is not None else ())
        ways = 1
        for name in names:
            ways *= MESH[name]
        n *= -(-size // ways)
    return n * itemsize


def _ref_argument_bytes(arch: str, shape: str, n: int, opts=frozenset()) -> int:
    """A cell's arguments, each leaf's local bytes from the reference's specs and shapes (as its
    ``build_cell`` places them): bf16 params; f32 moments, the int32 step and the batch (train);
    the batch (prefill); the cache and the step's tokens (decode)."""
    cfg = dataclasses.replace(jax_registry.get(arch), n_layers=n)
    jm = jax_build_model(cfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    mesh = types.SimpleNamespace(axis_names=("data", "model"))
    pshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    pspec = jax_shd.param_pspecs(pshape, mesh)
    inputs = jax_registry.input_specs(arch, shape)
    sp = jax_registry.SHAPES[shape]
    trees = [(pshape, pspec)]
    if sp.kind == "train":
        oshape = jax.eval_shape(jax_adamw.init, pshape)
        trees += [(oshape, jax_shd.opt_pspecs(oshape, pspec)), (inputs, jax_shd.batch_pspecs(inputs, mesh))]
    elif sp.kind == "prefill":
        trees.append((inputs, jax_shd.batch_pspecs(inputs, mesh)))
    else:
        shard_seq = shape == "long_500k"
        cache = jax.eval_shape(lambda: jm.init_cache(sp.global_batch, sp.seq_len))
        kv_seq_axis = "model" if "cache_seq_model" in opts else None
        trees.append((cache, jax_shd.cache_pspecs(cache, mesh, shard_seq=shard_seq, kv_seq_axis=kv_seq_axis)))
        toks = {"tokens": inputs["tokens"], "positions": inputs["positions"]}
        trees.append((toks, {k: jax.sharding.PartitionSpec() for k in toks} if shard_seq
                      else jax_shd.batch_pspecs(toks, mesh)))
    total = 0
    for tree, specs in trees:
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        total += sum(_ref_local_bytes(s, leaf.shape, np.dtype(leaf.dtype).itemsize)
                     for leaf, s in zip(leaves, spec_leaves))
    return total


def test_argument_bytes_equal_the_references_specs(records):
    """The granite-8b train cell (2 layers): bf16 params, f32 moments, the int32 step and
    batch, each leaf's local bytes from the reference's specs and shapes."""
    arch, shape, n = CELLS["dense"]
    assert records["dense"]["argument_bytes"] == _ref_argument_bytes(arch, shape, n)


@pytest.mark.parametrize("arch", list(MOE_CELLS))
def test_moe_cells(moe_records, arch):
    """The MoE archs' cells run under DTensor: the reference's keys, finite numbers, the
    arguments of the reference's specs, the expert-parallel dispatch's collectives."""
    shape, n = MOE_CELLS[arch]
    rec = moe_records[arch]
    assert set(rec) == KEYS and (rec["arch"], rec["shape"], rec["n_layers"]) == (arch, shape, n)
    for key in ("flops", "bytes_accessed", "argument_bytes", "output_bytes", "temp_bytes"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["argument_bytes"] == _ref_argument_bytes(arch, shape, n)
    # the counts gathered over data, the partial outputs and the buffer's slots reduced
    assert rec["collectives"].get("all-gather_count", 0) > 0 and rec["collectives"].get("all-reduce_count", 0) > 0
    if registry.SHAPES[shape].kind == "train":
        assert rec["collectives"].get("reduce-scatter_count", 0) > 0 and rec["alias_bytes"] > 0


@pytest.mark.parametrize("opt", list(OPTION_CELLS))
def test_constraint_options(option_records, opt):
    arch, shape, n = OPTION_CELLS[opt]
    rec = option_records[opt]
    assert rec["opts"] == [opt] and (rec["arch"], rec["shape"]) == (arch, shape)
    assert rec["argument_bytes"] == _ref_argument_bytes(arch, shape, n, frozenset({opt}))
    for key in ("flops", "bytes_accessed", "temp_bytes"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key


def test_cache_seq_model_places_the_kv_cache_over_model():
    """hymba-1.5b's long_500k cell: every KV leaf's sequence dim moves from ``data`` to ``model``;
    the SSM state's placements stay."""
    from torch.distributed.tensor import Shard

    cfg = dataclasses.replace(registry.get("hymba-1.5b"), n_layers=4)
    mesh = dryrun.production_mesh("single")
    caches = {opts: dryrun.build_cell(cfg, "long_500k", mesh, opts)[1][1]
              for opts in (frozenset(), frozenset({"cache_seq_model"}))}
    moved = 0
    for name, layer in caches[frozenset({"cache_seq_model"})].items():
        for leaf, t in layer.items():
            before = caches[frozenset()][name][leaf].placements
            if leaf in ("k", "v"):
                seq = next(p.dim for p in before if isinstance(p, Shard))
                assert tuple(before) != tuple(t.placements) and t.placements[1] == Shard(seq), (name, leaf)
                moved += 1
            else:
                assert tuple(before) == tuple(t.placements), (name, leaf)
    assert moved == 2 * cfg.n_layers


def test_moe_cap_data_splits_the_expert_work(moe_records, option_records):
    """dbrx-132b's decode step: with capacity over data the experts' einsums run on each data
    rank's capacity rows only, not on all of them on every data rank."""
    assert option_records["moe_cap_data"]["flops"] < moe_records["dbrx-132b"]["flops"]
    colls = option_records["moe_cap_data"]["collectives"]
    assert colls.get("reduce-scatter_count", 0) > 0  # the buffer's slots, along C


def test_probes_extrapolate_exactly():
    """rwkv6-7b's decode cell at 3 layers (probes 1 and 2, extrapolated) against the
    3-layer cell run whole."""
    cfg = dataclasses.replace(registry.get("rwkv6-7b"), n_layers=3)
    mesh = dryrun.production_mesh("single")
    whole = dryrun._measure(cfg, "decode_32k", mesh, frozenset())
    rec = dryrun.run_cell("rwkv6-7b", "decode_32k", "single", None, n_layers=3)
    assert rec["probe_depths"] == [1, 2]
    for key in ("flops", "bytes_accessed", "output_bytes"):
        assert rec[key] == pytest.approx(whole[key], rel=1e-9), key
    assert rec["argument_bytes"] == whole["argument_bytes"]
    assert rec["collectives"] == pytest.approx(whole["collectives"])


def test_probe_plans():
    for arch in registry.ARCHS:
        cfg = registry.get(arch)
        cfgs, weights, depths = dryrun.probes(cfg)
        assert len(cfgs) == len(weights) == len(depths) and sum(weights) == pytest.approx(1.0)
    cfgs, weights, depths = dryrun.probes(registry.get("hymba-1.5b"))
    assert depths == [4, 5] and weights == [-27.0, 28.0]  # 32 = 4 + 28 more swa layers
    cfgs, _, depths = dryrun.probes(registry.get("llama-3.2-vision-90b"))
    assert depths == [registry.get("llama-3.2-vision-90b").cross_every, 2 * registry.get(
        "llama-3.2-vision-90b").cross_every]


def test_unknown_options_are_refused():
    with pytest.raises(ValueError, match="unknown --opt"):
        dryrun.main(["--arch", "granite-8b", "--shape", "train_4k", "--opt", "seq_data"])


def test_a_failing_cell_prints_fail_and_exits_nonzero(tmp_path, capsys):
    with pytest.raises(SystemExit, match="1 dry-run cells failed"):
        dryrun.main(["--arch", "granite-8b", "--shape", "no_such_shape", "--mesh", "single", "--out", str(tmp_path)])
    assert "FAIL granite-8b x no_such_shape x single" in capsys.readouterr().out


def _record(**kw):
    rec = {"arch": "granite-8b", "shape": "train_4k", "mesh": "single", "devices": 256, "flops": 4e14,
           "bytes_accessed": 6.7e12, "argument_bytes": 2**30, "temp_bytes": 3 * 2**30,
           "collectives": {"all-gather_bytes": 5e10, "all-gather_count": 10, "reduce-scatter_bytes": 5e10}}
    rec.update(kw)
    return rec


def test_roofline_terms_use_the_h100s_constants():
    row = roofline.analyze_record(_record())
    mf = roofline.model_flops("granite-8b", "train_4k")
    assert mf == 6.0 * registry.get("granite-8b").n_active_params() * 256 * 4096
    assert row["t_compute_s"] == pytest.approx(mf / 256 / 989e12)
    assert row["t_memory_s"] == pytest.approx(6.7e12 / 3.35e12)
    assert row["t_collective_s"] == pytest.approx(1e11 / 50e9)
    assert row["dominant"] == max(("compute", "memory", "collective"), key=lambda k: row[f"t_{k}_s"])
    assert row["bytes_per_device_gib"] == pytest.approx(4.0)
    assert row["model_over_recorded"] == pytest.approx(mf / 256 / 4e14)
    assert 0 < row["roofline_fraction"] <= 1


def test_roofline_table_and_records(tmp_path, capsys):
    for shape, flops in (("train_4k", 4e14), ("decode_32k", 1e12)):
        rec = _record(shape=shape, flops=flops, bytes_accessed=1e9 if shape == "train_4k" else 9e12)
        (tmp_path / f"granite-8b__{shape}__single.json").write_text(json.dumps(rec))
    (tmp_path / "granite-8b__train_4k__multi.json").write_text(json.dumps(_record(mesh="multi", devices=512)))
    (tmp_path / "granite-8b__train_4k__single@seq_model.json").write_text(json.dumps(_record(opts=["seq_model"])))
    assert len(roofline.load_records(tmp_path, "single")) == 2
    assert [r["opts"] for r in roofline.load_records(tmp_path, "single", "seq_model")] == [["seq_model"]]
    roofline.main(["--dir", str(tmp_path), "--mesh", "single", "--json-out", str(tmp_path / "rows.json")])
    out = capsys.readouterr().out
    assert "| granite-8b | decode_32k |" in out and "2 cells;" in out and "reckoned, not measured" in out
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert [r["shape"] for r in rows] == sorted((r["shape"] for r in rows),
                                                key=lambda s: next(x["roofline_fraction"] for x in rows
                                                                   if x["shape"] == s))
    assert {r["dominant"] for r in rows} <= {"compute", "memory", "collective"}
