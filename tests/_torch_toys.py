"""Echo+1 toy models for the port's serving tests, one in each package.

The reference's serving tests drive the engine with an echo+1 LM (next token
= last token + 1 mod 17; the cache records the tokens).  ``JaxToy`` is that
model, speaking the chunked-prefill protocol; ``Toy`` is the same model in
torch, updating caches in place as the port's models do.  ``status_equal``
and ``same_requests`` compare what both engines report.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

VOCAB = 17


class JaxToy:
    """The reference tests' echo+1 LM, speaking the chunked-prefill protocol."""

    def init_cache(self, b, cache_len):
        return {"k": jnp.zeros((b, cache_len), jnp.float32), "mem": jnp.zeros((2, b, 4), jnp.float32)}

    def prefill(self, params, batch, cache_len):
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len)
        cache["k"] = cache["k"].at[:, :s].set(tokens.astype(jnp.float32))
        cache["mem"] = cache["mem"] + 1.0
        return jax.nn.one_hot((tokens[:, -1:] + 1) % VOCAB, VOCAB), cache

    def decode_step(self, params, cache, tokens, positions):
        b = tokens.shape[0]
        cache = dict(cache)
        cache["k"] = cache["k"].at[jnp.arange(b), positions].set(tokens[:, 0].astype(jnp.float32))
        return jax.nn.one_hot((tokens + 1) % VOCAB, VOCAB), cache

    def supports_chunked_prefill(self):
        return True

    def prefill_chunk(self, params, cache, tokens, start, last_row=None):
        cache = dict(cache)
        pos = start + jnp.arange(tokens.shape[1])
        cache["k"] = cache["k"].at[:, pos].set(tokens.astype(jnp.float32), mode="drop")
        last = tokens[:, -1:] if last_row is None else jax.lax.dynamic_slice_in_dim(
            tokens, jnp.asarray(last_row, jnp.int32), 1, axis=1)
        return jax.nn.one_hot((last + 1) % VOCAB, VOCAB), cache


class Toy:
    """The same echo+1 LM in torch: caches updated in place, as the port's models do."""

    device = torch.device("cpu")

    def init_cache(self, b, cache_len):
        return {"k": torch.zeros((b, cache_len)), "mem": torch.zeros((2, b, 4))}

    def _logits(self, tokens):
        return torch.nn.functional.one_hot((tokens + 1) % VOCAB, VOCAB).float()

    def prefill(self, params, batch, cache_len):
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len)
        cache["k"][:, :s] = tokens.float()
        cache["mem"] += 1.0
        return self._logits(tokens[:, -1:]), cache

    def decode_step(self, params, cache, tokens, positions):
        cache["k"][torch.arange(tokens.shape[0]), positions] = tokens[:, 0].float()
        return self._logits(tokens), cache

    def supports_chunked_prefill(self):
        return True

    def prefill_chunk(self, params, cache, tokens, start, last_row=None):
        t, s = cache["k"].shape[1], tokens.shape[1]
        rel = torch.arange(t) - start
        inside = (rel >= 0) & (rel < s)
        cache["k"].copy_(torch.where(inside[None], tokens.float().index_select(1, rel.clamp(0, s - 1)), cache["k"]))
        last = tokens[:, -1:] if last_row is None else tokens.index_select(1, torch.as_tensor(last_row).reshape(1))
        return self._logits(last), cache


def status_equal(ts, js):
    """Every ``EngineStatus`` field equal, the pool's two ratios to 1e-6."""
    got, want = dataclasses.asdict(ts), dataclasses.asdict(js)
    for key in ("pool_utilization", "pool_fragmentation"):
        assert got.pop(key) == pytest.approx(want.pop(key), abs=1e-6), key
    assert got == want
    assert ts.prefix_hit_rate == pytest.approx(js.prefix_hit_rate, abs=1e-12)


def same_requests(pairs):
    """Equal outputs, states and counters for each (JAX request, port request)."""
    for jr, tr in pairs:
        assert (tr.output, tr.state, tr.done, tr.preemptions, tr.truncated_tokens) == (
            jr.output, jr.state, jr.done, jr.preemptions, jr.truncated_tokens)
