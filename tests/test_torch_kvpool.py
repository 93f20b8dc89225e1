"""The port's paged KV pool against the JAX package's, operation for operation.

Each of the reference's pool tests (``tests/test_kvpool.py``: probing, block
accounting, gather/scatter, prefix sharing) runs here on both pools at once,
the echo toy cache built by each package's own ``init_cache``: after every
step the block tables, refcounts, free lists and ``stats()`` must be equal,
and so must the dense views ``gather`` builds (exactly: both move the same
f32 values).  The same holds over one longer operation sequence on the
layouts of the port's real models: reduced granite-8b, granite-8b with an
int8 cache, Hymba at 4 layers (global k/v paged, the sliding-window ring and
the SSM state lane rows) and RWKV6 (lane rows only).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import _scatter_slot
from repro.serve.kvpool import KVPool as JaxPool
from repro.serve.kvpool import probe_cache_layout as jax_probe
from repro_torch.models.model import build_model
from repro_torch.serve.kvpool import KVPool, probe_cache_layout


class JaxToy:
    """Echo cache: "k" is (B, L) batch-leading, "mem" is (2, B, 4) layer-leading."""

    def init_cache(self, b, cache_len):
        return {"k": jnp.zeros((b, cache_len), jnp.float32), "mem": jnp.zeros((2, b, 4), jnp.float32)}


class Toy:
    def init_cache(self, b, cache_len):
        return {"k": torch.zeros((b, cache_len)), "mem": torch.zeros((2, b, 4))}


class JaxReplicated:
    def init_cache(self, b, cache_len):
        return {"k": jnp.zeros((b, cache_len, 2), jnp.float32), "rope": jnp.zeros((16, 8), jnp.float32)}


class Replicated:
    """Adds a leaf with neither a batch nor a length axis (shared rotary table)."""

    def init_cache(self, b, cache_len):
        return {"k": torch.zeros((b, cache_len, 2)), "rope": torch.zeros((16, 8))}


def _tree_equal(got, want, *, tol=0.0):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for key in got:
            _tree_equal(got[key], want[key], tol=tol)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=tol, atol=tol)


def _same(jp: JaxPool, tp: KVPool, *, tol=0.0):
    """Equal bookkeeping, statistics and dense views of every lane."""
    assert [tp.block_table(lane) for lane in range(tp.lanes)] == [jp.block_table(lane) for lane in range(jp.lanes)]
    assert tp._rc == jp._rc and tp._free == jp._free and tp._retired == jp._retired
    assert tp.stats() == jp.stats()
    assert (tp.free_blocks, tp.used_blocks, tp.retired_blocks, tp.shared_blocks) == (
        jp.free_blocks, jp.used_blocks, jp.retired_blocks, jp.shared_blocks)
    _tree_equal(tp.gather(range(tp.lanes)), jp.gather(range(jp.lanes)), tol=tol)


def _pools(**kw):
    kw.setdefault("lanes", 4)
    kw.setdefault("cache_len", 32)
    kw.setdefault("block_size", 8)
    return JaxPool(JaxToy(), **kw), KVPool(Toy(), **kw)


class Both:
    """Run one pool operation on both pools; return both results."""

    def __init__(self, jp, tp):
        self.jp, self.tp = jp, tp

    def __getattr__(self, name):
        def call(*args, **kw):
            return getattr(self.jp, name)(*args, **kw), getattr(self.tp, name)(*args, **kw)
        return call


def _prefill_pair(tokens, cache_len=32):
    """A single-sequence toy cache the way a prefill would build it, in both packages."""
    k = np.zeros((1, cache_len), np.float32)
    k[0, :len(tokens)] = tokens
    mem = np.ones((2, 1, 4), np.float32)
    return {"k": jnp.asarray(k), "mem": jnp.asarray(mem)}, {"k": torch.from_numpy(k), "mem": torch.from_numpy(mem)}


# ---------------------------------------------------------------------------
# layout probing
# ---------------------------------------------------------------------------
def test_probe_classifies_paged_and_lane_leaves():
    specs = probe_cache_layout(Toy().init_cache, cache_len=32, block_size=8)
    jspecs, _ = jax_probe(JaxToy().init_cache, cache_len=32, block_size=8)
    assert [dataclasses.astuple(s) for s in specs.values()] == [dataclasses.astuple(s) for s in jspecs]
    k, mem = specs["['k']"], specs["['mem']"]
    assert k.kind == "paged" and (k.batch_axis, k.length_axis) == (0, 1)
    assert mem.kind == "lane" and mem.batch_axis == 1


def test_probe_classifies_replicated_leaf():
    specs = probe_cache_layout(Replicated().init_cache, cache_len=32, block_size=8)
    assert specs["['k']"].kind == "paged" and specs["['rope']"].kind == "replicated"


def test_probe_rejects_structure_changes():
    def shifty(b, cache_len):
        if b == 3:
            return {"k": torch.zeros((b, cache_len))}
        return {"k": torch.zeros((b, cache_len)), "extra": torch.zeros((b, 2))}

    with pytest.raises(ValueError):
        probe_cache_layout(shifty, cache_len=32, block_size=8)


# ---------------------------------------------------------------------------
# block accounting
# ---------------------------------------------------------------------------
def test_pool_defaults_and_invariants():
    jp, tp = _pools()
    assert tp.n_blocks == jp.n_blocks == 16 and tp.block_size == 8 and tp.blocks_per_lane == 4
    assert tp.free_blocks == 16 and tp.used_blocks == 0
    assert [tp.blocks_needed(n) for n in (1, 8, 9, 32)] == [jp.blocks_needed(n) for n in (1, 8, 9, 32)] == [1, 1, 2, 4]
    _same(jp, tp)


def test_pool_rejects_bad_geometry():
    with pytest.raises(ValueError):
        KVPool(Toy(), lanes=4, cache_len=32, block_size=7)
    with pytest.raises(ValueError):
        KVPool(Toy(), lanes=4, cache_len=32, block_size=8, n_blocks=3)


def test_ensure_release_and_fragmentation():
    jp, tp = _pools(lanes=2, n_blocks=6)
    both = Both(jp, tp)
    assert both.ensure(0, 20) == (True, True)
    assert both.ensure(1, 10) == (True, True)
    both.note_tokens(0, 20)
    _same(jp, tp)
    t0, t1 = tp.block_table(0), tp.block_table(1)
    assert not (set(t0) & set(t1)) and 0 not in t0 + t1
    assert both.ensure(0, 28) == (True, True)
    assert both.ensure(1, 24) == (False, False)  # pool dry: the caller must preempt
    assert tp.block_table(1) == t1
    assert both.release(0) == (4, 4)
    assert both.ensure(1, 24) == (True, True)
    _same(jp, tp)


def test_can_fit_tracks_free_and_retired():
    jp, tp = _pools(lanes=2, n_blocks=4)
    both = Both(jp, tp)
    both.ensure(0, 24)
    assert both.can_fit(8) == (True, True) and both.can_fit(9) == (False, False)
    both.retire(0)
    assert tp.retired_blocks == jp.retired_blocks == 3 and both.can_fit(32) == (True, True)
    _same(jp, tp)


def test_retire_is_lazy_until_pressure():
    jp, tp = _pools(lanes=2, n_blocks=4)
    both = Both(jp, tp)
    jc, tc = _prefill_pair([5.0] * 8)
    both.ensure(0, 8)
    jp.admit(0, jc)
    tp.admit(0, tc)
    both.retire(0)
    assert tp.gather([0])["k"][0, :8].sum().item() == 40.0  # retired content still readable
    _same(jp, tp)
    assert both.ensure(1, 32) == (True, True)  # harvests the retired lane
    assert tp.retired_blocks == 0 and tp.block_table(0) == ()
    _same(jp, tp)


# ---------------------------------------------------------------------------
# gather / scatter semantics
# ---------------------------------------------------------------------------
def test_admit_gather_round_trip():
    jp, tp = _pools()
    toks = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0, 5.0]  # spans two blocks
    jc, tc = _prefill_pair(toks)
    Both(jp, tp).ensure(2, len(toks))
    jp.admit(2, jc)
    tp.admit(2, tc)
    dense = tp.gather([0, 1, 2, 3])
    np.testing.assert_array_equal(dense["k"][2, :len(toks)].numpy(), toks)
    assert dense["k"][[0, 1, 3]].sum().item() == 0
    np.testing.assert_array_equal(dense["mem"][:, 2].numpy(), 1.0)
    _same(jp, tp)


def test_scatter_gather_matches_dense_scatter_slot():
    """Paged admit + gather reproduces the reference's dense ``_scatter_slot`` layout."""
    lanes, cache_len = 4, 32
    jp, tp = _pools(lanes=lanes, cache_len=cache_len)
    dense = JaxToy().init_cache(lanes, cache_len)
    rng = np.random.default_rng(0)
    for lane in (0, 2, 3):
        toks = rng.integers(1, 9, size=int(rng.integers(3, 17))).astype(np.float32)
        jc, tc = _prefill_pair(toks, cache_len)
        Both(jp, tp).ensure(lane, len(toks))
        jp.admit(lane, jc)
        tp.admit(lane, tc)
        dense = {k: _scatter_slot(dense[k], jc[k], slot=lane, max_batch=lanes) for k in dense}
    got = tp.gather(range(lanes))
    for key in dense:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(dense[key]))
    _same(jp, tp)


def test_scatter_writes_back_and_scratch_stays_zero():
    jp, tp = _pools(lanes=2, cache_len=16, block_size=8, n_blocks=4)
    both = Both(jp, tp)
    both.ensure(0, 16)
    both.ensure(1, 8)
    jv, tv = jp.gather([0, 1]), tp.gather([0, 1])
    jv["k"] = jv["k"].at[0, 11].set(7.0).at[1, 3].set(2.0)
    jv["mem"] = jv["mem"] + 0.5
    tv["k"][0, 11], tv["k"][1, 3] = 7.0, 2.0
    tv["mem"] += 0.5
    jp.scatter([0, 1], jv)
    tp.scatter([0, 1], tv)
    back = tp.gather([0, 1])
    assert back["k"][0, 11].item() == 7.0 and back["k"][1, 3].item() == 2.0 and back["mem"].min().item() == 0.5
    _same(jp, tp)
    # A lane with a short table reads zeros past its allocation (the scratch block).
    jp2, tp2 = _pools(lanes=2, cache_len=16, block_size=8, n_blocks=4)
    Both(jp2, tp2).ensure(0, 8)
    jp2.scatter([0, 1], {k: v + 1.0 for k, v in jp2.gather([0, 1]).items()})
    tp2.scatter([0, 1], {k: v + 1.0 for k, v in tp2.gather([0, 1]).items()})
    after = tp2.gather([0, 1])["k"]
    assert after[0, :8].min().item() == 1.0 and after[0, 8:].sum().item() == 0 and after[1].sum().item() == 0
    _same(jp2, tp2)


def test_dense_degenerate_mode_matches_seed_layout():
    jp, tp = JaxPool(JaxToy(), lanes=3, cache_len=16), KVPool(Toy(), lanes=3, cache_len=16)
    assert tp.block_size == 16 and tp.n_blocks == 3
    both = Both(jp, tp)
    for lane in range(3):
        both.ensure(lane, 16)
    base = Toy().init_cache(3, 16)
    got = tp.gather(range(3))
    for key in base:
        assert torch.equal(got[key], base[key])
    jc, tc = _prefill_pair([4.0, 2.0], 16)
    both.ensure(1, 2)
    jp.admit(1, jc)
    tp.admit(1, tc)
    np.testing.assert_array_equal(tp.gather(range(3))["k"][1, :2].numpy(), [4.0, 2.0])
    _same(jp, tp)


# ---------------------------------------------------------------------------
# prefix sharing (refcounts, index lifecycle)
# ---------------------------------------------------------------------------
def test_refcount_lifecycle_and_shared_release():
    jp, tp = _pools(lanes=3, n_blocks=6)
    both = Both(jp, tp)
    toks = list(range(100, 120))  # two full blocks and a partial third
    both.ensure(0, 21)
    assert both.register_prefix(0, toks) == (2, 2)
    jm, tm = both.match_prefix(toks + [1, 2])
    assert tm == jm == list(tp.block_table(0))[:2]
    both.alias(1, tm)
    assert tp.block_refcount(tm[0]) == 2 and tp.lane_holds_shared(0) and tp.lane_holds_shared(1)
    assert tp.shared_blocks == 2
    _same(jp, tp)
    assert both.release(0) == (1, 1)  # only the private frontier block
    assert both.match_prefix(toks) == (tm, tm)
    assert both.release(1) == (2, 2)
    assert both.match_prefix(toks, peek=True) == ([], [])
    assert tp.shared_blocks == 0 and tp.free_blocks == 6
    _same(jp, tp)


def test_match_prefix_stops_at_content_divergence():
    jp, tp = _pools(lanes=2, n_blocks=6)
    both = Both(jp, tp)
    toks = list(range(24))
    both.ensure(0, 24)
    assert both.register_prefix(0, toks) == (3, 3)
    diverged = toks[:8] + [99] + toks[9:]
    first = [tp.block_table(0)[0]]
    assert both.match_prefix(diverged, peek=True) == (first, first)
    assert both.match_prefix([7] + toks[1:], peek=True) == ([], [])
    # The chain hashes are Python's over the same int tuples, so equal to the reference's.
    assert tp._chain_hashes(np.arange(24, dtype=np.int32)) == jp._chain_hashes(np.arange(24, dtype=np.int32))
    _same(jp, tp)


def test_admit_prefix_survives_reclaiming_its_own_lane():
    jp, tp = _pools(lanes=2, n_blocks=4)
    both = Both(jp, tp)
    toks = list(range(16))
    both.ensure(0, 17)
    both.register_prefix(0, toks)
    shared = list(tp.block_table(0))[:2]
    both.retire(0)
    assert both.admit_prefix(0, toks + [5]) == (16, 16)
    assert list(tp.block_table(0)) == shared and tp.block_refcount(shared[0]) == 1
    _same(jp, tp)


def test_retired_lane_keeps_prefix_until_harvested():
    jp, tp = _pools(lanes=2, n_blocks=4)
    both = Both(jp, tp)
    toks = list(range(16))
    both.ensure(0, 16)
    both.register_prefix(0, toks)
    both.retire(0)
    assert tp.match_prefix(toks, peek=True) == list(tp.block_table(0))
    assert both.ensure(1, 32) == (True, True)
    assert both.match_prefix(toks, peek=True) == ([], [])
    _same(jp, tp)


def test_alias_rejects_bad_targets():
    _, tp = _pools(lanes=2, n_blocks=4)
    tp.ensure(0, 8)
    with pytest.raises(ValueError):
        tp.alias(1, [3])  # unallocated block
    tp.ensure(1, 8)
    with pytest.raises(ValueError):
        tp.alias(1, list(tp.block_table(0)))  # non-empty table


def test_stats_track_sharing_and_fragmentation():
    jp, tp = _pools(lanes=2, n_blocks=6)
    both = Both(jp, tp)
    both.ensure(0, 9)
    both.note_tokens(0, 9)
    assert tp.stats()["fragmentation"] == pytest.approx(1 - 9 / 16)
    both.match_prefix(range(8))  # a miss
    toks = list(range(8))
    both.register_prefix(0, toks)
    jh, th = both.match_prefix(toks)
    both.match_prefix(toks, peek=True)  # a router probe: not counted
    both.alias(1, th)
    st = tp.stats()
    assert st["prefix_lookups"] == 2 and st["prefix_hits"] == 1
    assert st["prefix_hit_rate"] == 0.5 and st["prefix_hit_tokens"] == 8 and st["shared_blocks"] == 1
    _same(jp, tp)


def test_replicated_leaf_passes_through_unpooled():
    jp = JaxPool(JaxReplicated(), lanes=2, cache_len=32, block_size=8)
    tp = KVPool(Replicated(), lanes=2, cache_len=32, block_size=8)
    Both(jp, tp).ensure(0, 8)
    view = tp.gather([0, 1])
    assert tuple(view["rope"].shape) == (16, 8)
    view["rope"] = view["rope"] + 3.0
    view["k"][0, 1, :] = 9.0
    tp.scatter([0, 1], view)
    back = tp.gather([0, 1])
    assert back["rope"].min().item() == 3.0 and back["k"][0, 1].min().item() == 9.0
    with pytest.raises(NotImplementedError):
        tp.decode_view(2)  # a fixed view cannot hold a leaf scatter rebinds


# ---------------------------------------------------------------------------
# the real models' layouts
# ---------------------------------------------------------------------------
def _layout_pair(arch, n_layers=None, kv_quant=False):
    jm, jp, tm, tp = reduced_pair(arch, n_layers)
    if kv_quant:
        jm = jax_build_model(jm.cfg, dtype=jnp.float32, param_dtype=jnp.float32, kv_quant=True)
        tm = build_model(tm.cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu", kv_quant=True)
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch, n_layers, kv_quant, kinds", [
    ("granite-8b", None, False, {"paged"}),
    ("granite-8b", None, True, {"paged"}),
    ("hymba-1.5b", 4, False, {"paged", "lane"}),
    ("rwkv6-7b", None, False, {"lane"}),
])
def test_operation_sequence_on_model_layouts(arch, n_layers, kv_quant, kinds):
    """Admissions of real prefill caches, growth under pressure, prefix
    registration and aliasing, a decode-view round trip with an edit, retire,
    harvest and release: equal tables, refcounts, free lists, stats and
    gathered views after every step (rtol = atol = 1e-4, the serving tests'
    tolerance: the two packages' prefills; the int8 values equal)."""
    jm, jparams, tm, tparams = _layout_pair(arch, n_layers, kv_quant)
    kw = dict(lanes=3, cache_len=64, block_size=16, n_blocks=7)
    jpool, tpool = JaxPool(jm, **kw), KVPool(tm, **kw)
    assert {s.kind for s in tpool.specs.values()} == kinds
    assert sorted(dataclasses.astuple(s) for s in tpool.specs.values()) == sorted(
        dataclasses.astuple(s) for s in jpool.specs)
    both = Both(jpool, tpool)
    rng = np.random.default_rng(5)
    system = rng.integers(0, tm.cfg.vocab, 32).astype(np.int32)
    for lane, tail in ((0, 9), (1, 3)):
        toks = np.concatenate([system, rng.integers(0, tm.cfg.vocab, tail).astype(np.int32)])
        _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[None])}, 64)
        _, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[None].astype(np.int64))}, 64)
        assert both.ensure(lane, len(toks)) == (True, True)
        jpool.admit(lane, jc)
        tpool.admit(lane, tc)
        both.note_tokens(lane, len(toks))
        _same(jpool, tpool, tol=1e-4)
    assert both.register_prefix(0, system) == (2, 2)
    jm_, tm_ = both.match_prefix(np.concatenate([system, [1, 2]]))
    assert tm_ == jm_ and len(tm_) == 2
    both.alias(2, tm_)
    assert both.ensure(2, 40) == (True, True)
    assert both.ensure(0, 64) == (False, False)  # 7 blocks: the pool runs dry
    _same(jpool, tpool, tol=1e-4)
    # A decode-view round trip: every paged and lane leaf edited, scattered back.
    lanes = [2, 0, 1]
    jv, tv = jpool.gather(lanes), tpool.gather(lanes)
    jv = {k: (v + 1 if not isinstance(v, dict) else {kk: vv + 1 for kk, vv in v.items()}) for k, v in jv.items()}
    tv = {k: (v + 1 if not isinstance(v, dict) else {kk: vv + 1 for kk, vv in v.items()}) for k, v in tv.items()}
    jpool.scatter(lanes, jv)
    tpool.scatter(lanes, tv)
    _same(jpool, tpool, tol=1e-4)
    both.retire(1)
    assert both.ensure(0, 64) == (True, True)  # harvests lane 1
    both.reset_lane_state(2)
    _same(jpool, tpool, tol=1e-4)
    assert both.release(0) == (2, 2)  # the two shared blocks stay with lane 2
    _same(jpool, tpool, tol=1e-4)
