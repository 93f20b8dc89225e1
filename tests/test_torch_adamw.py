"""The port's AdamW against the JAX package's.

``schedule`` over warmup, decay and past the end, ``global_norm``, and three
``update`` steps from the same numpy params and gradients (f32 params and a
bf16 leaf; f32 gradients and ``grad_dtype="bfloat16"``'s rounded ones):
params, both moments, the step and the metrics within 1e-6 (relative, and
absolute for values near zero: the two packages sum in other orders).
The port updates in place and keeps f32 moments for a bf16 param.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro_torch.optim import adamw

TOL = dict(rtol=1e-6, atol=1e-6)


def _np_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "emb": {"embed": rng.standard_normal((16, 8), dtype=np.float32)},
        "blocks": {"w": rng.standard_normal((2, 8, 12), dtype=np.float32) * 0.3,
                   "ln": 1 + 0.1 * rng.standard_normal((2, 8), dtype=np.float32)},
        "final_norm": rng.standard_normal(8, dtype=np.float32),
    }


def _torch(tree: dict, bf16_paths=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch(v, [p[len(k) + 1:] for p in bf16_paths if p.startswith(k + "/")])
        else:
            t = torch.from_numpy(v.copy())
            out[k] = t.to(torch.bfloat16) if k in bf16_paths else t
    return out


def _jax(tree: dict, bf16_paths=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _jax(v, [p[len(k) + 1:] for p in bf16_paths if p.startswith(k + "/")])
        else:
            out[k] = jnp.asarray(v, dtype=jnp.bfloat16 if k in bf16_paths else jnp.float32)
    return out


def _close(got: dict, ref: dict) -> None:
    ref_leaves = dict(adamw.trainable(jax.tree.map(lambda a: np.asarray(a, np.float32), ref)))
    got_leaves = dict(adamw.trainable(got))
    assert set(ref_leaves) == set(got_leaves)
    for path, r in ref_leaves.items():
        np.testing.assert_allclose(got_leaves[path].float().numpy(), r, **TOL, err_msg=path)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 2500, 9999, 10_000, 20_000])
def test_schedule_equal_reference(step):
    for cfg_kw in ({}, {"warmup_steps": 0, "total_steps": 10}, {"lr": 1e-2, "min_lr_ratio": 0.0}):
        got = adamw.schedule(adamw.AdamWConfig(**cfg_kw), step)
        ref = jax_adamw.schedule(jax_adamw.AdamWConfig(**cfg_kw), jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_global_norm_equal_reference():
    tree = _np_tree(3)
    np.testing.assert_allclose(float(adamw.global_norm(_torch(tree, ["blocks/w"]))),
                               float(jax_adamw.global_norm(_jax(tree, ["blocks/w"]))), **TOL)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_paths", [(), ("blocks/w",)], ids=["f32", "bf16_leaf"])
def test_three_updates_equal_reference(grad_dtype, bf16_paths):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5, grad_dtype=grad_dtype)
    tcfg, jcfg = adamw.AdamWConfig(**kw), jax_adamw.AdamWConfig(**kw)
    params_np = _np_tree(0)
    tp, jp = _torch(params_np, bf16_paths), _jax(params_np, bf16_paths)
    ts, js = adamw.init(tp), jax_adamw.init(jp)
    for _, m in adamw.trainable(ts.m):
        assert m.dtype == torch.float32
    for i in range(3):
        grads_np = jax.tree.map(lambda a: a * (1 + i), _np_tree(10 + i))
        gdt = jnp.bfloat16 if grad_dtype == "bfloat16" else jnp.float32
        jg = jax.tree.map(lambda a: jnp.asarray(a, gdt), grads_np)
        tg = _torch(grads_np)
        if grad_dtype == "bfloat16":
            tg = jax.tree.map(lambda t: t.to(torch.bfloat16), tg)
        before = {p: t.data_ptr() for p, t in adamw.trainable(tp)}
        tp, ts, tmet = adamw.update(tcfg, tg, ts, tp)
        jp, js, jmet = jax_adamw.update(jcfg, jg, js, jp)
        assert {p: t.data_ptr() for p, t in adamw.trainable(tp)} == before  # in place
        _close(tp, jp)
        _close(ts.m, js.m)
        _close(ts.v, js.v)
        assert int(ts.step) == int(js.step) == i + 1 and ts.step.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL)
    for path, t in adamw.trainable(tp):
        assert t.dtype == (torch.bfloat16 if path in bf16_paths else torch.float32)


def test_derived_embed_t_is_not_trained():
    params = _torch(_np_tree(1))
    params["emb"]["embed_t"] = params["emb"]["embed"].t().contiguous()
    assert [p for p, _ in adamw.trainable(params)] == ["blocks/ln", "blocks/w", "emb/embed", "final_norm"]
    state = adamw.init(params)
    assert "embed_t" not in state.m["emb"] and "embed_t" not in state.v["emb"]
