"""The embedding's gradient (``layers.table_grad``) against the JAX package's, on the CPU.

``layers.embed_tokens`` looks rows up through ``_TableRows``, whose backward
sums each token's gradient rows in f32 in the order they occur (the rows
gathered in the tokens' stable sort order, ``segment_reduce`` over each
token's run), so two backward passes on the card are bitwise equal; the
autograd gradient of ``table[tokens]`` adds them with atomics there.  Here it
is held within 1e-6 of ``jax.vjp`` of ``embed[tokens]`` and of autograd's
gradient of the plain lookup, on numpy inputs with repeated tokens.  The
card's check (bitwise twice) is in ``tests/test_torch_gemm_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import layers

TOL = 1e-6  # relative to the gradient's max: f32 sums of the same rows in other orders


def _inputs(seed, rows, d, shape):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, d), dtype=np.float32)
    # A skewed draw, so some tokens repeat many times and some rows get none.
    tokens = np.minimum(rng.geometric(0.15, size=shape) - 1, rows - 1).astype(np.int64)
    cot = rng.standard_normal((*shape, d), dtype=np.float32)
    return table, tokens, cot


@pytest.mark.parametrize("rows,d,shape", [(50, 16, (2, 16)), (300, 64, (4, 33)), (7, 8, (1, 5)), (64, 32, (3,))])
def test_table_grad_matches_jax_vjp(rows, d, shape):
    table, tokens, cot = _inputs(rows + d, rows, d, shape)
    _, vjp = jax.vjp(lambda w: w[jnp.asarray(tokens)], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    want = np.asarray(want)
    scale = np.abs(want).max()
    w = torch.from_numpy(table).requires_grad_(True)
    out = layers.embed_tokens({"embed": w}, torch.from_numpy(tokens))
    (got,) = torch.autograd.grad(out, w, torch.from_numpy(cot))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, d)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=TOL)
    # autograd's gradient of the plain lookup, the card's former path
    wp = torch.from_numpy(table).requires_grad_(True)
    (plain,) = torch.autograd.grad(wp[torch.from_numpy(tokens)], wp, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy() / scale, plain.numpy() / scale, rtol=0, atol=TOL)
    # rows no token names get exact zeros
    unused = np.setdiff1d(np.arange(rows), tokens)
    assert not got[torch.from_numpy(unused)].any()


def test_table_grad_sums_in_token_order_and_casts_once():
    """A token's rows are summed in the order they occur, in f32, then cast to the table's dtype."""
    tokens = torch.tensor([[3, 1, 3], [3, 0, 1]])
    g = torch.tensor([1e8, 2.0, 1.0, -1e8, 5.0, 0.5]).reshape(2, 3, 1).repeat(1, 1, 2)
    got = layers.table_grad(tokens, g, 5, torch.float32)
    # token 3: (1e8 + 1) - 1e8 in f32 order of occurrence = 0 (1e8 + 1 rounds to 1e8)
    assert got[:, 0].tolist() == [5.0, 2.5, 0.0, 0.0, 0.0]
    bf = layers.table_grad(tokens, g.bfloat16(), 5, torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf[1, 0].item() == 2.5
    assert torch.equal(layers.table_grad(tokens, g, 5, torch.float32), got)
