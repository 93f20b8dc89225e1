"""The port's sharding rules against the JAX package's, and its placements.

  * for all ten archs at full width, ``param_pspecs``, ``batch_pspecs``,
    ``cache_pspecs`` and ``opt_pspecs`` equal the reference's entry for entry,
    on the production meshes' axis names.  The reference's side reads shapes
    from ``jax.eval_shape``, the port's from meta tensors (nothing is
    allocated on either side);
  * ``placements()`` on 1-, 2- and 3-axis meshes;
  * ``topology_from_env`` / ``fleet_data_config`` against the reference's on
    the same environments.
"""
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jax_registry
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.dist import sharding as jax_shd
from repro.launch import fleet as jax_fleet
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch import fleet
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

ARCHS = list(registry.ARCHS)
MESHES = {"single": ("data", "model"), "multi": ("pod", "data", "model"), "data": ("data",)}


def _jax_mesh(axes):
    return types.SimpleNamespace(axis_names=axes)


def _flat_jax(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else str(getattr(p, "name", p)) for p in path)
        out[key] = leaf
    return out


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    items = tree._asdict().items() if hasattr(tree, "_asdict") else tree.items()
    for key, value in items:
        if isinstance(value, dict) or hasattr(value, "_asdict"):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _same(port: dict, ref: dict, what: str) -> None:
    assert set(port) >= set(ref), (what, sorted(set(ref) - set(port)))
    for key, spec in ref.items():
        assert isinstance(port[key], shd.P), (what, key)
        assert tuple(port[key]) == tuple(spec), (what, key, port[key], spec)


def _models(arch: str):
    jm = jax_build_model(jax_registry.get(arch), dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tm = build_model(registry.get(arch), dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="meta")
    return jm, tm


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch, mesh):
    axes = MESHES[mesh]
    jm, tm = _models(arch)
    jshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jspec = jax_shd.param_pspecs(jshape, _jax_mesh(axes))
    params = tm.init()
    assert all(t.is_meta for _, t in adamw.trainable(params))
    tspec = shd.param_pspecs(params, axes)
    _same(_flat(tspec), _flat_jax(jspec), "params")
    jopt = jax_shd.opt_pspecs(jax.eval_shape(jax_adamw.init, jshape), jspec)
    topt = shd.opt_pspecs(adamw.init(params), tspec)
    assert tuple(topt.step) == tuple(jopt.step) == ()
    for part in ("m", "v"):
        _same(_flat(getattr(topt, part)), _flat_jax(getattr(jopt, part)), part)


@pytest.mark.parametrize("mesh", ["single", "multi", "data"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch, mesh):
    axes = MESHES[mesh]
    for shape in registry.shapes_for(arch):
        for shard_seq in (False, True):
            ref = jax_shd.batch_pspecs(jax_registry.input_specs(arch, shape), _jax_mesh(axes), shard_seq=shard_seq)
            got = shd.batch_pspecs(registry.input_specs(arch, shape), axes, shard_seq=shard_seq)
            assert set(got) == set(ref)
            for key in ref:
                assert tuple(got[key]) == tuple(ref[key]), (shape, shard_seq, key)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, mesh):
    axes = MESHES[mesh]
    jm, tm = _models(arch)
    for shape in ("decode_32k", "long_500k") if arch in ("rwkv6-7b", "hymba-1.5b") else ("decode_32k",):
        sp = registry.SHAPES[shape]
        jcache = jax.eval_shape(lambda: jm.init_cache(sp.global_batch, sp.seq_len))
        tcache = tm.init_cache(sp.global_batch, sp.seq_len)
        if registry.get(arch).family == "audio":  # the decoder's encoder memory, as the dry runs add it
            jcache = dict(jcache, memory=jax.ShapeDtypeStruct((sp.global_batch, sp.seq_len, jm.cfg.d_model),
                                                              jnp.bfloat16))
            tcache = dict(tcache, memory=torch.empty((sp.global_batch, sp.seq_len, tm.cfg.d_model), device="meta"))
        for shard_seq in (False, True):
            for kv_seq_axis in (None, "model"):
                ref = jax_shd.cache_pspecs(jcache, _jax_mesh(axes), shard_seq=shard_seq, kv_seq_axis=kv_seq_axis)
                got = shd.cache_pspecs(tcache, axes, shard_seq=shard_seq, kv_seq_axis=kv_seq_axis)
                assert _flat(got).keys() == _flat_jax(ref).keys()
                _same(_flat(got), _flat_jax(ref), f"{shape} cache shard_seq={shard_seq} kv_seq_axis={kv_seq_axis}")


@pytest.mark.parametrize("spec, axes, want", [
    (shd.P("data"), ("data",), (Shard(0),)),
    (shd.P(), ("data",), (Replicate(),)),
    (shd.P(None, "data", "model"), ("data", "model"), (Shard(1), Shard(2))),
    (shd.P(None, "model", "data"), ("data", "model"), (Shard(2), Shard(1))),
    (shd.P("model", None), ("data", "model"), (Replicate(), Shard(0))),
    (shd.P(None, None), ("data", "model"), (Replicate(), Replicate())),
    (shd.P(("pod", "data"), None), ("pod", "data", "model"), (Shard(0), Shard(0), Replicate())),
    (shd.P(None, ("data",), None), ("pod", "data", "model"), (Replicate(), Shard(1), Replicate())),
    (shd.P(None, "model", "data", None), ("pod", "data", "model"), (Replicate(), Shard(2), Shard(1))),
])
def test_placements(spec, axes, want):
    assert shd.placements(spec, axes) == want


def test_placements_refuse_an_axis_named_twice():
    with pytest.raises(ValueError, match="names mesh axis 'data'"):
        shd.placements(shd.P("data", "data"), ("data", "model"))


ENVS = [
    {},
    {"REPRO_COORDINATOR": "10.0.0.1:9999", "REPRO_NUM_PROCESSES": "4", "REPRO_PROCESS_ID": "3"},
    {"REPRO_COORDINATOR": "host7", "REPRO_NUM_PROCESSES": "2", "REPRO_PROCESS_ID": "1"},
    {"SLURM_LAUNCH_NODE_IPADDR": "10.1.2.3", "SLURM_NTASKS": "8", "SLURM_PROCID": "5"},
    {"SLURM_LAUNCH_NODE_IPADDR": "10.1.2.3:1234", "SLURM_NTASKS": "8", "SLURM_PROCID": "0",
     "REPRO_PROCESS_ID": "2"},
]


@pytest.mark.parametrize("env", ENVS)
def test_topology_and_data_config_equal_reference(env):
    ref, got = jax_fleet.topology_from_env(env), fleet.topology_from_env(env)
    assert (got.coordinator, got.num_processes, got.process_id, got.is_multihost) == (
        ref.coordinator, ref.num_processes, ref.process_id, ref.is_multihost)
    want = jax_fleet.fleet_data_config(JaxDataConfig(global_batch=16, seq_len=32), ref)
    have = fleet.fleet_data_config(DataConfig(global_batch=16, seq_len=32), got)
    assert (have.host_index, have.host_count, have.global_batch, have.local_batch) == (
        want.host_index, want.host_count, want.global_batch, want.local_batch)


def test_topology_refusals_equal_reference():
    bad = {"REPRO_NUM_PROCESSES": "2", "REPRO_PROCESS_ID": "2"}
    with pytest.raises(ValueError, match="out of range"):
        jax_fleet.topology_from_env(bad)
    with pytest.raises(ValueError, match="out of range"):
        fleet.topology_from_env(bad)
    topo = fleet.topology_from_env({"REPRO_NUM_PROCESSES": "3"})
    with pytest.raises(ValueError, match="not divisible by 3 hosts"):
        fleet.fleet_data_config(DataConfig(global_batch=16), topo)


def test_initialize_is_a_no_op_for_one_process_and_refuses_nccl_without_a_card(monkeypatch):
    import torch.distributed as dist

    assert fleet.initialize(fleet.topology_from_env({})).num_processes == 1
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        fleet.initialize(fleet.FleetTopology("127.0.0.1:1", 2, 0))
    with pytest.raises(ValueError, match="backend must be"):
        fleet.initialize(fleet.FleetTopology("127.0.0.1:1", 2, 0), backend="mpi")


# ---------------------------------------------------------------------------
# the activation and MoE-buffer constraints (layers.shard_act / shard_moe_buf)
# ---------------------------------------------------------------------------
def _norm(spec) -> tuple:
    """A spec as a tuple, a one-name tuple entry as that name (``P`` normalises so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.fixture
def constraints(monkeypatch):
    """Both packages' constraint settings, reset after the test; the reference's specs
    captured from its ``with_sharding_constraint`` calls."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    captured = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: captured.append(spec) or x)
    yield jax_layers, layers, captured
    for pkg in (jax_layers, layers):
        pkg.set_activation_sharding(None, None)
        pkg.set_moe_sharding(None, None)


def _dp(mesh: str):
    return ("pod", "data") if mesh == "multi" else ("data",)


# (batch, seq) as the reference's build_cell sets them: no option (and cache_seq_model,
# moe_cap_data), seq_model (train and prefill), long_500k
ACT = {"default": lambda dp: (dp, None), "seq_model": lambda dp: (dp, "model"), "long_500k": lambda dp: (None, "data")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("option", list(ACT))
def test_activation_spec_equals_reference(constraints, option, mesh):
    jax_layers, layers, captured = constraints
    axes = MESHES[mesh]
    for pkg in (jax_layers, layers):
        pkg.set_activation_sharding(*ACT[option](_dp(mesh)))
    for shape in ((8, 16, 32), (8, 16), (8, 16, 4, 8)):
        captured.clear()
        jax_layers.shard_act(jnp.zeros(shape))
        assert len(captured) == 1
        got = layers.act_spec(torch.empty(shape, device="meta"), axes)
        assert isinstance(got, shd.P) and _norm(got) == _norm(captured[0]), (shape, got, captured[0])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_default_activation_spec_is_the_reference_launchers(constraints, mesh):
    """With nothing set the port anchors the batch over the data axes: the spec the reference's
    launcher sets for every cell that is not long_500k or seq_model."""
    jax_layers, layers, captured = constraints
    jax_layers.set_activation_sharding(_dp(mesh), None)
    jax_layers.shard_act(jnp.zeros((8, 16, 32)))
    assert _norm(layers.act_spec(torch.empty((8, 16, 32), device="meta"), MESHES[mesh])) == _norm(captured[0])


@pytest.mark.parametrize("ep, cap", [("model", "data"), ("model", None), (None, "data"), (("pod", "data"), "model")])
def test_moe_buffer_spec_equals_reference(constraints, ep, cap):
    """``moe_cap_data`` is ("model", "data"); the others are what ``set_moe_sharding`` takes."""
    jax_layers, layers, captured = constraints
    for pkg in (jax_layers, layers):
        pkg.set_moe_sharding(ep, cap)
    for shape in ((4, 6, 8), (4, 6)):
        captured.clear()
        jax_layers.shard_moe_buf(jnp.zeros(shape))
        got = layers.moe_buf_spec(len(shape))
        assert isinstance(got, shd.P) and _norm(got) == _norm(captured[0]), (shape, got, captured[0])


def test_default_moe_buffer_spec(constraints):
    """Unset, the reference leaves the buffer to GSPMD (no constraint); the port keeps experts over
    ``model``, as the expert weights are, and capacity replicated: the reference's spec for
    ``set_moe_sharding("model", None)``."""
    jax_layers, layers, captured = constraints
    jax_layers.shard_moe_buf(jnp.zeros((4, 6, 8)))
    assert captured == []
    jax_layers.set_moe_sharding("model", None)
    jax_layers.shard_moe_buf(jnp.zeros((4, 6, 8)))
    assert _norm(layers.moe_buf_spec(3)) == _norm(captured[0]) == ("model", None, None)
    assert shd.placements(layers.moe_buf_spec(3), MESHES["multi"]) == (Replicate(), Replicate(), Shard(0))
    layers.set_moe_sharding("model", "data")
    assert shd.placements(layers.moe_buf_spec(3), MESHES["multi"]) == (Replicate(), Shard(1), Shard(0))


def test_constraints_pass_plain_tensors():
    from repro_torch.models import layers

    x = torch.ones(4, 6, 8)
    layers.set_moe_sharding("model", "data")
    layers.set_activation_sharding(("data",), "model")
    try:
        assert layers.shard_moe_buf(x) is x and layers.shard_act(x) is x
    finally:
        layers.set_moe_sharding(None, None)
        layers.set_activation_sharding(None, None)
