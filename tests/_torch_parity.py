"""Shared set-up for the port's parity tests: one reduced model in both packages.

The JAX reference model is built and initialised in f32 from
``jax.random.PRNGKey(0)``; its params go to the port through
``repro_torch.weights.params_from_jax``, so both compute on the same weights.
``model_pair`` does the same from the numpy tree, in which a QKV-bias
config's zero biases are first replaced by seeded normals.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import registry as torch_registry
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.weights import params_from_jax


@functools.cache
def reduced_pair(arch: str, n_layers: int | None = None, capacity_factor: float | None = None):
    """(jax_model, jax_params, torch_model, torch_params) for ``arch``.reduced(), f32, CPU.

    ``n_layers`` overrides the reduced depth (2): a 4-layer Hymba has a
    sliding-window layer, the 2-layer one only global layers.
    ``capacity_factor`` overrides an MoE config's."""
    jcfg = jax_registry.get(arch).reduced()
    tcfg = torch_registry.get(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    jm = jax_build_model(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build_model(tcfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu", dtype=torch.float32)
    return jm, jp, tm, tp


def model_pair(arch: str):
    """(jax model, jax params, port model, port params) for reduced ``arch`` in
    f32; a ``qkv_bias`` config's zero-initialised biases are replaced in the
    numpy tree by seeded normals before either package uses them."""
    jcfg, tcfg = jax_registry.get(arch).reduced(), torch_registry.get(arch).reduced()
    jm = jax_build_model(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if tcfg.qkv_bias:
        rng = np.random.default_rng(11)
        attn = np_params["blocks"]["attn"]
        for key in ("bq", "bk", "bv"):
            attn[key] = rng.standard_normal(attn[key].shape).astype(np.float32) * 0.5
    jp = jax.tree.map(jnp.asarray, np_params)
    tm = torch_build_model(tcfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, tcfg, device="cpu", dtype=torch.float32)
