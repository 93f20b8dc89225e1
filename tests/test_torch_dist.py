"""The port's sharded training against the JAX package's global-batch step.

Gloo jobs on the CPU (``tests/_torch_dist_jobs.py``, children that import only
``repro_torch``): reduced granite-8b, rwkv6-7b and 4-layer hymba-1.5b take two
sharded steps each on meshes (2, 1), (1, 2) (two processes) and (2, 2)
(four), params and moments sharded by ``param_pspecs`` / ``opt_pspecs``,
every rank feeding its data coordinate's host shard of the batch.  The
reference, in this process, takes two ``make_train_step`` steps on the
global batch (every host shard concatenated, from its own pipeline) from the
same numpy params.  As ``tests/test_torch_train.py`` holds the unsharded
port, metrics are held within 1e-5 and every leaf within 1e-4 of its max,
with AdamW's eps at 1e-4 (that file says why).  rwkv6-7b's step-2 gradient
norm and ``u`` carry the packages' known gap (that file states it: ``u``
starts at zero, so its first update is its gradient's sign): the gradient
norm is held within that file's 2e-4 (the sharding's own summation order
moves it by 1.5e-5 too), and ``u`` within 5e-4 of its max of the port's own
unsharded step on the same global batch and of the other meshes' runs: its
step-1 update g / (|g| + eps) turns each summation order's rounding of a
gradient near eps into a visible step, and the runs read 2.6e-4 (2, 2)
against unsharded, 3.4e-4 (2, 2) against (2, 1), 3.6e-4 unsharded against
the reference.  The sharded
runs are also held to each other.  A checkpoint written on (2, 1)
restores onto (1, 2) with equal leaves; ``launch.train --fleet --device cpu``
trains on two processes.

Reduced qwen3-moe-235b-a22b trains on the same meshes (experts over
``model``: each rank holds E / model of them), at its own capacity factor and
at 0.5, where experts overflow and which assignments are dropped depends on
the tokens of the other data ranks.  In the same jobs ``moe_ffn`` is held to
the unsharded function on the global input (``tests/_torch_dist_jobs.py``):
output, aux loss and every gradient within 1e-5 of their max, the kept mask
exactly, the local buffer (E / model, C, d), or (E / model, C / data, d)
under ``moe_cap_data``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Shard

from _torch_parity import reduced_pair
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import global_batch

ROOT = Path(__file__).resolve().parents[1]
JOBS = Path(__file__).resolve().parent / "_torch_dist_jobs.py"
# name -> (arch, n_layers, capacity_factor or None: the config's); Hymba's 4 layers hold a window layer
ARCHS = {"granite-8b": ("granite-8b", 2, None), "rwkv6-7b": ("rwkv6-7b", 2, None), "hymba-1.5b": ("hymba-1.5b", 4, None),
         "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", 2, None),
         "qwen3-moe-235b-a22b-cf0.5": ("qwen3-moe-235b-a22b", 2, 0.5)}
MOE = [name for name, (arch, _, _) in ARCHS.items() if arch.startswith("qwen3-moe")]
MESHES = ["2x1", "1x2", "2x2"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=2, eps=1e-4)
BATCH, SEQ, STEPS = 4, 16, 2
# rwkv6-7b's known gap between the packages (tests/test_torch_train.py): step 2's gradient norm and u.
DIVERGED = {"rwkv6-7b": (("grad_norm", 1), "blocks/rwkv/u")}


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
            "OMP_NUM_THREADS": "2"}


def _run(work: Path, tag: str, restore_from: str = "") -> None:
    world = int(np.prod([int(n) for n in tag.split("x")]))
    procs = [subprocess.Popen([sys.executable, str(JOBS), str(work), tag, str(rank), restore_from], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"mesh {tag} rank {rank} exited {p.returncode}:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two global-batch steps per arch, and the three sharded jobs."""
    work = tmp_path_factory.mktemp("dist")
    job = {"archs": {name: {"arch": a, "n_layers": n, "capacity_factor": cf} for name, (a, n, cf) in ARCHS.items()},
           "opt": OPT, "batch": BATCH, "seq": SEQ, "steps": STEPS}
    (work / "job.json").write_text(json.dumps(job))
    ref = {}
    for arch, (name, n_layers, cf) in ARCHS.items():
        jm, jp, tm, tp = reduced_pair(name, n_layers, cf)
        np.savez(work / f"{arch}.params.npz", **_flat(jax.tree.map(np.asarray, jp)))
        step_fn = jax_make_train_step(jm, jax_adamw.AdamWConfig(**OPT))
        port_fn = make_train_step(tm, adamw.AdamWConfig(**OPT))
        per_mesh = {}
        for hosts in (1, 2):  # data axes of size 1 ((1, 2)) and 2 ((2, 1), (2, 2))
            params, st, metrics = jp, jax_adamw.init(jp), []
            port_params = _clone(tp)
            port_state, port_metrics = adamw.init(port_params), []
            for step in range(STEPS):
                parts = [JaxPipeline(jm.cfg, JaxDataConfig(global_batch=BATCH, seq_len=SEQ, host_index=h,
                                                           host_count=hosts)).device_batch(step)
                         for h in range(hosts)]
                batch = {k: jax.numpy.concatenate([p[k] for p in parts]) for k in parts[0]}
                params, st, met = step_fn(params, st, batch)
                metrics.append({k: float(v) for k, v in met.items()})
                tbatch = global_batch(tm.cfg, DataConfig(global_batch=BATCH, seq_len=SEQ), step, hosts)
                port_params, port_state, met = port_fn(port_params, port_state, tbatch)
                port_metrics.append({k: float(v) for k, v in met.items()})
            per_mesh[hosts] = (metrics, _flat(jax.tree.map(np.asarray, params)), port_metrics,
                               {p: t.detach().numpy() for p, t in adamw.trainable(port_params)})
        ref[arch] = per_mesh
    _run(work, "2x1")
    _run(work, "1x2", restore_from="2x1")
    _run(work, "2x2")
    return work, ref


def _load(work: Path, arch: str, tag: str):
    meta = json.loads((work / f"{arch}.{tag}.json").read_text())
    with np.load(work / f"{arch}.{tag}.npz") as z:
        return meta, dict(z)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_steps_equal_reference(runs, arch, tag):
    work, ref = runs
    meta, params = _load(work, arch, tag)
    hosts = int(tag.split("x")[0])
    assert meta["data_shard"][1] == hosts
    ref_metrics, ref_params, port_metrics, port_params = ref[arch][hosts]
    metric_gap, leaf_gap = DIVERGED.get(arch, (None, None))
    assert len(meta["metrics"]) == STEPS
    for step, (got, want, port) in enumerate(zip(meta["metrics"], ref_metrics, port_metrics)):
        assert set(got) == set(want)
        for key in want:
            tol = 2e-4 if (key, step) == metric_gap else 1e-5
            np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=1e-6, err_msg=f"{tag} step {step} {key}")
            np.testing.assert_allclose(got[key], port[key], rtol=tol, atol=1e-6, err_msg=f"{tag} step {step} {key}")
    assert set(params) == set(ref_params) == set(port_params)
    rel = lambda a, b: np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    for path, a in params.items():
        tol = 5e-4 if path == leaf_gap else 1e-4
        assert rel(a, port_params[path]) <= tol, (tag, path, "unsharded port", rel(a, port_params[path]))
        if path != leaf_gap:
            assert rel(a, ref_params[path]) <= 1e-4, (tag, path, "reference", rel(a, ref_params[path]))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_runs_agree(runs, arch):
    """(2, 1) and (2, 2) feed the same global batch: their steps agree within 1e-5
    (metrics) and 1e-4 of each leaf's max, as each does with the reference
    (rwkv6-7b's step-2 gradient norm and ``u``: the module's note)."""
    work, _ = runs
    (m21, p21), (m22, p22) = _load(work, arch, "2x1"), _load(work, arch, "2x2")
    metric_gap, leaf_gap = DIVERGED.get(arch, (None, None))
    for step, (got, want) in enumerate(zip(m22["metrics"], m21["metrics"])):
        for key in want:
            tol = 2e-4 if (key, step) == metric_gap else 1e-5
            np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=1e-7, err_msg=key)
    for path, a in p22.items():
        tol = 5e-4 if path == leaf_gap else 1e-4
        assert np.abs(a - p21[path]).max() <= tol * max(np.abs(p21[path]).max(), 1e-30), path


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_sharded_step_issues_collectives(runs, arch, tag):
    """Every mesh gathers FSDP-sharded params and reduces gradients each step
    (``commanalysis.CollectiveCounter`` over the jobs' last step)."""
    meta, _ = _load(runs[0], arch, tag)
    colls = meta["collectives_last_step"]
    assert colls.get("all-gather_count", 0) > 0 and colls["all-gather_bytes"] > 0
    assert colls.get("reduce-scatter_count", 0) + colls.get("all-reduce_count", 0) > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_are_sharded_as_the_specs_say(runs, arch):
    """On (2, 2) a column-parallel weight holds a quarter, FSDP over data and TP over model."""
    work, _ = runs
    meta, params = _load(work, arch, "2x2")
    name = "blocks/rwkv/w_r" if arch == "rwkv6-7b" else "blocks/attn/wq"
    full = params[name].shape
    assert tuple(meta["local_shapes"][name]) == (full[0], full[1] // 2, full[2] // 2)
    assert meta["placements"][name] == [str(Shard(1)), str(Shard(2))]
    if arch in MOE:  # the expert stacks: experts over model, FSDP over data
        full = params["blocks/moe/w_gate"].shape
        assert tuple(meta["local_shapes"]["blocks/moe/w_gate"]) == (full[0], full[1] // 2, full[2] // 2, full[3])
        assert meta["placements"]["blocks/moe/w_gate"] == [str(Shard(2)), str(Shard(1))]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_checkpoint_restores_onto_another_mesh(runs, arch):
    """(2, 1)'s final state, written by its rank 0, restored onto (1, 2)'s placements and
    gathered: every param and first moment equal to what (2, 1) held."""
    work, _ = runs
    _, held = _load(work, arch, "2x1")
    with np.load(work / f"{arch}.restored.1x2.npz") as z:
        restored = dict(z)
    assert {p[len("params/"):] for p in restored if p.startswith("params/")} == set(held)
    for path, a in held.items():
        np.testing.assert_array_equal(restored[f"params/{path}"], a, err_msg=path)
    assert any(k.startswith("opt/m/") and np.abs(v).max() > 0 for k, v in restored.items())


def _moe(work: Path, arch: str, tag: str) -> list[dict]:
    world = int(np.prod([int(n) for n in tag.split("x")]))
    return [json.loads((work / f"{arch}.moe.{tag}.{rank}.json").read_text()) for rank in range(world)]


@pytest.mark.parametrize("variant", ["default", "moe_cap_data", "seq_model"])
@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", MOE)
def test_sharded_moe_ffn_equals_unsharded(runs, arch, tag, variant):
    """Every rank: ``moe_ffn``'s output, aux loss and gradients within 1e-5 of the unsharded
    function's on the global input, its own tokens' kept mask equal to the unsharded mask's rows,
    and its buffers (E / model, C, d), capacity split over data under ``moe_cap_data``."""
    data, model = (int(n) for n in tag.split("x"))
    cfg = ARCHS[arch]
    for rank in _moe(runs[0], arch, tag):
        got = rank[variant]
        worst = max(got["errors"].items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-5, (rank["rank"], worst)
        assert got["keep_equal"], rank["rank"]
        n_experts = 4  # the reduced config's
        cap = rank["capacity"] // data if variant == "moe_cap_data" else rank["capacity"]
        assert got["buffer_shapes"] == [[n_experts // model, cap, 64]], got["buffer_shapes"]
        colls = got["collectives"]
        if data > 1:  # the counts are gathered over data; with moe_cap_data the buffer is reduce-scattered
            assert colls.get("all-gather_count", 0) > 0
            if variant == "moe_cap_data":
                assert colls.get("reduce-scatter_count", 0) > 0
        if model > 1:  # the experts' partial outputs are summed over model
            assert colls.get("all-reduce_count", 0) > 0
        if variant == "seq_model" and model > 1:
            assert got["x_placements"] == [str(Shard(0)), str(Shard(1))]
    assert cfg[2] is None or rank["dropped"] > 0  # capacity factor 0.5: experts overflow


@pytest.mark.parametrize("tag", ["2x1", "2x2"])
def test_dropped_assignments_depend_on_other_data_ranks(runs, tag):
    """At capacity factor 0.5 a data rank routing its tokens alone (capacity and slots from its
    own tokens) keeps another set than the global routing the sharded layer reproduces."""
    ranks = _moe(runs[0], "qwen3-moe-235b-a22b-cf0.5", tag)
    assert all(r["dropped"] > 0 for r in ranks)
    assert any(r["alone_differs"] for r in ranks)
    assert all(r[v]["keep_equal"] for r in ranks for v in ("default", "moe_cap_data", "seq_model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_fleet_on_two_processes(tmp_path):
    """``launch.train --fleet --device cpu`` on two processes: both exit 0, rank 0 writes
    the checkpoints once, at steps 2 and 4, and a resume on two processes reaches 6."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    ckpt = tmp_path / "ck"
    port = _free_port()

    def run(steps: int) -> list[str]:
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--fleet", "--arch", "granite-8b", "--reduced",
                "--steps", str(steps), "--batch", "4", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", str(ckpt),
                "--device", "cpu"]
        env = {**_env(), "REPRO_NUM_PROCESSES": "2", "REPRO_COORDINATOR": f"127.0.0.1:{port}"}
        procs = [subprocess.Popen(argv, env={**env, "REPRO_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, cwd=tmp_path) for r in range(2)]
        outs = [p.communicate(timeout=240)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
        return outs

    outs = run(4)
    assert all(f"finished at step 4" in out for out in outs)
    assert "process 0 of 2: mesh (2, 1) ('data', 'model'), backend gloo" in outs[0]
    assert CheckpointManager(ckpt).steps() == [2, 4]
    port = _free_port()
    outs = run(6)
    assert all("finished at step 6" in out for out in outs)
    assert CheckpointManager(ckpt).steps() == [2, 4, 6]
