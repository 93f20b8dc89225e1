"""The port's training stack against the JAX package's.

  * four ``make_train_step`` steps on reduced granite-8b from the same
    weights and pipeline batches: losses, metrics and params against the
    reference's (and microbatches 1 against 2 in the port);
  * ``Trainer`` resume-exactness, preemption and a falling loss, as
    ``tests/test_trainer.py`` holds the reference's;
  * checkpoints cross-load both ways (the reference writes and the port
    restores; the port writes and the reference restores), in f32 and with a
    bf16 leaf;
  * the train CLI on the CPU with a ``host_cpu`` deployment, and its
    refusals;
  * ``EncDecLM.prefill`` and three ``decode_step``s against the reference's
    within 1e-4;
  * reduced rwkv6-7b and hymba-1.5b (4 layers): two ``make_train_step`` steps
    against the reference's, and a ``Trainer`` run, through the WKV / scan
    ops' backward (their plain versions here), the ops' calls counted by
    phase: each layer's forward, its recompute, its backward, every step.

The param comparisons run AdamW with eps 1e-4: at eps 1e-8 an element whose
gradient is summation noise (a cancelling sum near 1e-8, where the two
packages sum in other orders) takes a full ±lr step of the noise's sign, so
the comparison would hold the noise; at 1e-4 every update is proportional to
its gradient and the formulas are what is compared.  The losses are also
compared at the default eps.
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import registry as jax_registry
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import faults
from repro_torch.core.runtime import KernelRuntime
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.weights import params_from_jax


def _flat(tree) -> dict:
    return dict(adamw.trainable(tree))


def _steps(jm, jp, tm, tp, n, eps, micro=1, batch=4, seq=16):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=n, eps=eps)
    js = jax_make_train_step(jm, jax_adamw.AdamWConfig(**kw), num_microbatches=micro)
    ts = make_train_step(tm, adamw.AdamWConfig(**kw), num_microbatches=micro)
    jst, tst = jax_adamw.init(jp), adamw.init(tp)
    jpipe = JaxPipeline(jm.cfg, JaxDataConfig(global_batch=batch, seq_len=seq))
    tpipe = TokenPipeline(tm.cfg, DataConfig(global_batch=batch, seq_len=seq))
    jmets, tmets = [], []
    for step in range(n):
        jp, jst, jmet = js(jp, jst, jpipe.device_batch(step))
        tp, tst, tmet = ts(tp, tst, tpipe.device_batch(step, device="cpu"))
        jmets.append({k: float(v) for k, v in jmet.items()})
        tmets.append({k: float(v) for k, v in tmet.items()})
    return jp, tp, tst, jmets, tmets


@pytest.mark.parametrize("eps", [1e-4, 1e-8])
def test_four_steps_equal_reference(eps):
    jm, jp, tm, tp = reduced_pair("granite-8b")
    jp2, tp2, tst, jmets, tmets = _steps(jm, jp, tm, copy.deepcopy(tp), 4, eps)
    for jmet, tmet in zip(jmets, tmets):
        assert set(tmet) == set(jmet) == {"ce_loss", "aux_loss", "loss", "grad_norm", "lr"}
        for key in jmet:
            np.testing.assert_allclose(tmet[key], jmet[key], rtol=1e-5, atol=1e-6, err_msg=key)
    assert tmets[-1]["loss"] < tmets[0]["loss"] + 0.5 and int(tst.step) == 4
    if eps == 1e-4:
        ref = _flat(jax.tree.map(np.asarray, jp2))
        for path, t in _flat(tp2).items():
            np.testing.assert_allclose(t.detach().numpy(), ref[path], rtol=1e-4, atol=1e-6, err_msg=path)


def test_microbatches_equal_one_batch():
    _, _, tm, tp = reduced_pair("granite-8b")
    runs = {}
    for micro in (1, 2):
        p = copy.deepcopy(tp)
        step = make_train_step(tm, adamw.AdamWConfig(lr=1e-3, eps=1e-4), num_microbatches=micro)
        batch = TokenPipeline(tm.cfg, DataConfig(global_batch=4, seq_len=16)).device_batch(0, device="cpu")
        p, _, met = step(p, adamw.init(p), batch)
        runs[micro] = (p, met)
    assert set(runs[2][1]) == {"ce_loss", "loss", "grad_norm", "lr"}  # as the reference's microbatch metrics
    np.testing.assert_allclose(float(runs[1][1]["loss"]), float(runs[2][1]["loss"]), rtol=1e-5)
    for path, t in _flat(runs[1][0]).items():
        torch.testing.assert_close(_flat(runs[2][0])[path], t, rtol=1e-4, atol=1e-5, msg=path)


def _trainer(tmp_path, total=8, ckpt_every=4, lr=1e-3, batch=4, seq=16):
    cfg = registry.get("granite-8b").reduced()
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    tcfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(tmp_path), log_every=100)
    opt = adamw.AdamWConfig(lr=lr, total_steps=total, warmup_steps=5)
    return Trainer(model, cfg, DataConfig(global_batch=batch, seq_len=seq), opt, tcfg)


def _leaves(params) -> np.ndarray:
    return np.concatenate([t.detach().numpy().ravel() for _, t in adamw.trainable(params)])


def test_trainer_resume_exactness(tmp_path):
    """Interrupted-then-resumed == uninterrupted (deterministic pipeline)."""
    step, p_full, _, _ = _trainer(tmp_path / "a", total=6, ckpt_every=3).train()
    assert step == 6
    _trainer(tmp_path / "b", total=6, ckpt_every=3).train(stop_after=3)
    t3 = _trainer(tmp_path / "b", total=6, ckpt_every=3)
    assert t3.ckpt.latest_step() == 3
    step, p_resumed, opt, _ = t3.train()
    assert step == 6 and int(opt.step) == 6
    np.testing.assert_allclose(_leaves(p_full), _leaves(p_resumed), rtol=1e-5, atol=1e-6)


def test_trainer_params_serve_without_a_graph(tmp_path):
    """Params a Trainer returns come back with the ``requires_grad`` they were
    made with, so serving them runs no GEMM as the gradient op and builds no
    autograd graph, and gives the tokens that a detached copy gives."""
    t = _trainer(tmp_path, total=2, ckpt_every=100)
    _, params, _, _ = t.train()
    assert not any(p.requires_grad for _, p in adamw.trainable(params))
    prompt = np.arange(1, 6, dtype=np.int32)
    streams = {}
    for name, p in (("trained", params), ("copy", copy.deepcopy(params))):
        eng = ServingEngine(t.model, p, max_batch=2, cache_len=64, runtime=KernelRuntime())
        ops.GRAD_GEMMS.clear()
        streams[name] = list(eng.submit(prompt, max_new_tokens=4).tokens())
        assert not ops.GRAD_GEMMS, name
        assert all(c.grad_fn is None for c in torch.utils._pytree.tree_leaves(eng.pool.gather(range(2)))), name
    assert streams["trained"] == streams["copy"] and len(streams["trained"]) == 4


def test_trainer_preemption_checkpoints(tmp_path, monkeypatch):
    t = _trainer(tmp_path, total=50, ckpt_every=100)
    orig_enter = faults.PreemptionGuard.__enter__

    def patched(self):
        out = orig_enter(self)
        self.request()
        return out

    monkeypatch.setattr(faults.PreemptionGuard, "__enter__", patched)
    step, *_ = t.train()
    assert step == 1
    assert t.ckpt.latest_step() == 1  # emergency checkpoint committed


def test_trainer_loss_decreases(tmp_path):
    t = _trainer(tmp_path, total=45, ckpt_every=1000, lr=3e-3, batch=16, seq=64)
    t.tcfg.log_every = 5
    t.train()
    assert len(t.history) == 9 and t.history[-1]["step"] == 45
    assert t.history[-1]["loss"] < t.history[0]["loss"] - 0.3, t.history


def _jax_state(arch="granite-8b", bf16_leaf=False):
    cfg = jax_registry.get(arch).reduced()
    jm = jax_build_model(cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(3))
    if bf16_leaf:
        jp["final_norm"] = (jp["final_norm"] * 1.3).astype(jnp.bfloat16)
    js = jax_adamw.init(jp)
    js = js._replace(step=jnp.asarray(7, jnp.int32), m=jax.tree.map(lambda a: a + 0.25, js.m))
    return {"params": jp, "opt": js._asdict()}


def _torch_like(tree, bf16_leaf=False):
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.int32 if a.dtype == jnp.int32 else torch.float32),
                        tree)
    if bf16_leaf:
        like["params"]["final_norm"] = like["params"]["final_norm"].to(torch.bfloat16)
    return like


@pytest.mark.parametrize("bf16_leaf", [False, True], ids=["f32", "bf16_leaf"])
def test_checkpoint_reference_writes_port_restores(tmp_path, bf16_leaf):
    tree = _jax_state(bf16_leaf=bf16_leaf)
    JaxCheckpointManager(tmp_path).save(5, tree, extra={"note": "jax"})
    like = _torch_like(tree, bf16_leaf)
    step, got, extra = CheckpointManager(tmp_path).restore_latest(like)
    assert step == 5 and extra == {"note": "jax"}
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    flat_ref = dict(adamw.trainable(ref))
    for path, t in adamw.trainable(got):
        assert t.dtype == dict(adamw.trainable(like))[path].dtype, path
        np.testing.assert_array_equal(t.float().numpy(), flat_ref[path], err_msg=path)
    assert int(got["opt"]["step"]) == 7


@pytest.mark.parametrize("bf16_leaf", [False, True], ids=["f32", "bf16_leaf"])
def test_checkpoint_port_writes_reference_restores(tmp_path, bf16_leaf):
    ref_tree = _jax_state(bf16_leaf=bf16_leaf)
    like = _torch_like(ref_tree, bf16_leaf)
    # The port's state: the reference's values as tensors, with a tied-style derived leaf that is never saved.
    src = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), ref_tree)
    src["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    if bf16_leaf:
        src["params"]["final_norm"] = src["params"]["final_norm"].to(torch.bfloat16)
    src["params"]["emb"]["embed_t"] = src["params"]["emb"]["embed"].t().contiguous()
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save_async(9, src, extra={"note": "port"})
    mgr.wait()
    manifest = json.loads((tmp_path / "step_9" / "manifest.json").read_text())
    assert "params/emb/embed_t" not in manifest["keys"] and "opt/step" in manifest["keys"]
    got, extra = JaxCheckpointManager(tmp_path).restore(9, ref_tree)
    assert extra == {"note": "port"}
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_flatten_with_path(ref_tree)[0]):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    # ...and the port reads its own file back, rebuilding embed_t.
    like["params"]["emb"]["embed_t"] = torch.zeros(1)
    back, _ = mgr.restore(9, like)
    torch.testing.assert_close(back["params"]["emb"]["embed_t"], back["params"]["emb"]["embed"].t())


def test_checkpoint_shape_check_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2)}}
    for step in (1, 2, 3):
        mgr.save(step, tree)
    (tmp_path / "step_4.tmp").mkdir()
    assert mgr.steps() == [2, 3]
    mgr.save(4, tree)
    assert mgr.steps() == [3, 4] and not (tmp_path / "step_4.tmp").exists()
    with pytest.raises(ValueError, match="checkpoint shape"):
        mgr.restore(4, {"a": torch.ones(4), "b": {"c": torch.zeros(2, 2)}})
    with pytest.raises(KeyError, match="missing array 'b/d'"):
        mgr.restore(4, {"a": torch.ones(3), "b": {"d": torch.zeros(2, 2)}})


def test_train_cli_on_cpu_with_a_host_cpu_deployment(tmp_path, capsys, monkeypatch):
    from repro_torch.core import tuner

    fleet = tuner.tune_fleet(device_names=("host_cpu",), cpu_problems=3, n_kernels=3)
    path = tmp_path / "deploy.json"
    fleet.bundle.deployments["host_cpu"].save(str(path))
    argv = ["--arch", "granite-8b", "--reduced", "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--deployment", str(path), "--device", "cpu"]
    step, metrics = train_cli.main(argv)
    out = capsys.readouterr().out
    assert step == 4 and np.isfinite(metrics["loss"])
    assert f"installed kernel deployment from {path}" in out and "finished at step 4" in out
    assert CheckpointManager(tmp_path / "ck").steps() == [2, 4]
    step, _ = train_cli.main([a if a != "4" else "6" for a in argv])  # resumes from step 4's checkpoint
    assert step == 6 and CheckpointManager(tmp_path / "ck").steps() == [2, 4, 6]
    for var in ("REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    step, _ = train_cli.main([a if a != "4" else "8" for a in argv] + ["--fleet"])  # one process: no group, no mesh
    assert step == 8 and CheckpointManager(tmp_path / "ck").steps() == [4, 6, 8]


def test_train_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--arch", "granite-8b", "--reduced", "--steps", "1"])


def test_encdec_prefill_and_decode_match_reference():
    jm, jp, tm, tp = reduced_pair("seamless-m4t-large-v2")
    cfg, cache_len = tm.cfg, 32
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab, (2, 12)).astype(np.int32)
    frames = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, cache_len)
    with torch.no_grad():
        tlogits, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                                          "frames": torch.from_numpy(frames)}, cache_len)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **tol)
    assert set(tcache) == set(jcache) == {"k", "v", "memory"}
    assert set(tm.init_cache(2, cache_len)) == set(jm.init_cache(2, cache_len)) == {"k", "v"}
    pos = np.array([12, 12], np.int32)
    for i in range(3):
        nxt = np.argmax(np.asarray(jlogits)[:, -1], axis=-1).astype(np.int32)[:, None]
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos + i))
        with torch.no_grad():
            tlogits, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt).long(),
                                             torch.from_numpy(pos + i).long())
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **tol, err_msg=f"decode {i}")
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **tol, err_msg=key)


def test_facade_reaches_the_training_stack():
    import repro_torch

    assert repro_torch.Trainer is Trainer and repro_torch.TrainerConfig is TrainerConfig
    assert repro_torch.DataConfig is DataConfig and repro_torch.TokenPipeline is TokenPipeline
    assert repro_torch.AdamWConfig is adamw.AdamWConfig and repro_torch.make_train_step is make_train_step
    assert repro_torch.CheckpointManager is CheckpointManager
    assert "Trainer" not in repro_torch.__all__  # __all__ keeps the reference's names


RECURRENT = {"rwkv6-7b": ("wkv", None), "hymba-1.5b": ("ssm_scan_fused", 4)}


@pytest.mark.parametrize("arch", list(RECURRENT))
def test_recurrent_steps_equal_reference(arch):
    """Two train steps of reduced rwkv6-7b / hymba-1.5b through the recurrence's
    op (forward, remat recompute, backward each layer) against the reference's."""
    op, layers = RECURRENT[arch]
    jm, jp, tm, tp = reduced_pair(arch, layers)
    ops.GRAD_SCANS.clear()
    jp2, tp2, _, jmets, tmets = _steps(jm, jp, tm, copy.deepcopy(tp), 2, 1e-4, batch=2)
    n = tm.cfg.n_layers
    assert ops.grad_scans(op) == {"forward": 2 * n, "recompute": 2 * n, "backward": 2 * n}
    # rwkv6-7b's u starts at zero, so after step 1 it is the AdamW update itself, which divides
    # each element's gradient by |g| + eps: u's gradients agree within 1e-6 of their max, and u
    # after step 1 within 4.1e-5 of its max. The step-2 gradient norm at the port's own params
    # then differs from the reference's by 1.4e-4; at the reference's params it agrees within 1e-5
    # (test_rwkv_step_two_gradients_at_the_references_params). Those two readings keep 2e-4.
    diverged_metric, diverged_leaf = (("grad_norm", 1), "blocks/rwkv/u") if arch == "rwkv6-7b" else (None, None)
    for step, (jmet, tmet) in enumerate(zip(jmets, tmets)):
        for key in jmet:
            tol = 2e-4 if (key, step) == diverged_metric else 1e-5
            np.testing.assert_allclose(tmet[key], jmet[key], rtol=tol, atol=1e-6, err_msg=f"step {step + 1} {key}")
    # The params after both steps, each leaf relative to its largest value.
    ref = _flat(jax.tree.map(np.asarray, jp2))
    for path, t in _flat(tp2).items():
        err = np.abs(t.detach().numpy() - ref[path]).max() / np.abs(ref[path]).max()
        assert err <= (2e-4 if path == diverged_leaf else 1e-4), (path, err)


def test_rwkv_step_two_gradients_at_the_references_params():
    """Step 2 of reduced rwkv6-7b at the reference's params after step 1: the
    port's gradient norm within 1e-5 of the reference's evaluated with f64
    params (its WKV stays f32), and every gradient within 1e-4 of its max.
    The reference's own f32 gradients of w_k and w_r are 1.5e-4 / 1.2e-4 of
    their max from that evaluation here, so it is the one compared with."""
    jm, jp, tm, _ = reduced_pair("rwkv6-7b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=2, eps=1e-4)
    jpipe = JaxPipeline(jm.cfg, JaxDataConfig(global_batch=2, seq_len=16))
    jp1, _, _ = jax_make_train_step(jm, jax_adamw.AdamWConfig(**kw))(jp, jax_adamw.init(jp), jpipe.device_batch(0))
    np1 = jax.tree.map(np.asarray, jp1)
    batch = jax.tree.map(np.asarray, jpipe.device_batch(1))
    with jax.enable_x64(True):
        jm64 = jax_build_model(jm.cfg, dtype=jnp.float64, param_dtype=jnp.float64)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), np1)
        (jloss, _), jgrads = jax.value_and_grad(jm64.loss_fn, has_aux=True)(p64, jax.tree.map(jnp.asarray, batch))
        jloss, ref = float(jloss), _flat(jax.tree.map(np.asarray, jgrads))
    tp1 = params_from_jax(np1, tm.cfg, device="cpu", dtype=torch.float32)
    tbatch = TokenPipeline(tm.cfg, DataConfig(global_batch=2, seq_len=16)).device_batch(1, device="cpu")
    ops.GRAD_SCANS.clear()
    loss, _, grads = make_train_step(tm, adamw.AdamWConfig(**kw)).compute_grads(tp1, tbatch)
    assert ops.grad_scans("wkv")["backward"] == tm.cfg.n_layers
    got = {p: t.detach().double().numpy() for p, t in _flat(grads).items()}
    assert set(got) == set(ref)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    norm = lambda g: np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in g.values()))
    np.testing.assert_allclose(norm(got), norm(ref), rtol=1e-5)
    for path, r in ref.items():
        assert np.abs(got[path] - r).max() <= 1e-4 * np.abs(r).max(), path


@pytest.mark.parametrize("arch", list(RECURRENT))
def test_recurrent_trainer_counts_the_ops_by_phase(tmp_path, arch):
    """A ``Trainer`` on reduced rwkv6-7b / hymba-1.5b: 3 steps, a finite loss, a
    checkpoint, and per step n_layers x (forward + recompute + backward) calls
    of the recurrence's op (none of the other recurrence's)."""
    op, layers = RECURRENT[arch]
    cfg = registry.get(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    t = Trainer(model, cfg, DataConfig(global_batch=2, seq_len=16), adamw.AdamWConfig(lr=1e-3, total_steps=3),
                TrainerConfig(total_steps=3, ckpt_every=3, ckpt_dir=str(tmp_path), log_every=1))
    ops.GRAD_SCANS.clear()
    step, params, _, metrics = t.train()
    n = cfg.n_layers
    assert step == 3 and t.ckpt.latest_step() == 3
    assert all(np.isfinite(h["loss"]) for h in t.history) and len(t.history) == 3
    assert dict(ops.GRAD_SCANS) == {(op, "forward"): 3 * n, (op, "recompute"): 3 * n, (op, "backward"): 3 * n}
    assert not any(p.requires_grad for _, p in adamw.trainable(params))
