"""Block-allocated paged KV cache for the serving tier, ported from ``repro/serve/kvpool.py``.

Cache storage is a pool of ``n_blocks`` fixed-size **blocks** of
``block_size`` tokens each, plus one permanently-zero **scratch block** (id
0) that pads partially-filled lanes.  Every live request (a **lane**) owns an
ordered **block table**: the blocks that back its tokens, allocated on admit
and grown as decode advances.  Models never see blocks: ``gather`` builds a
dense ``(W, cache_len, ...)`` decode view from the tables and ``scatter``
writes an updated view back.  ``block_size=None`` degenerates to one
``cache_len``-sized block per lane, the seed engine's dense layout.

Cache leaves are classified structurally, as the reference's
``probe_cache_layout`` does: ``model.init_cache`` is probed at two (batch,
length) points and each leaf's scaling axes decide its kind.  A cache is a
dict of tensors, nested or not (Hymba's is ``{"layer{i}": {"k", "v",
"ssm"}}``); each leaf is named by its path in the reference's ``keystr``
form (``"['layer1']['k']"``), and ``gather`` / ``scatter`` / ``admit`` take
and return the model's own tree.

* **paged** leaves have a batch axis and a length axis that tracks
  ``cache_len`` exactly (k/v token caches, and an int8 cache's scales).  They
  live in the block store, whose batch axis indexes blocks: ``(n_blocks + 1)``
  rows of ``block_size`` tokens, row 0 the scratch block.  The length axis
  follows the batch axis in every model of the port, so the blocks of a lane
  gathered along the batch axis reshape, without a copy, into its
  ``cache_len`` tokens.
* **lane** leaves have a batch axis but no length axis that tracks
  ``cache_len`` (the RWKV6 wkv/x1/x2 and Hymba SSM recurrent state, and
  sliding-window rings shorter than ``cache_len``: a Hymba ring of
  ``min(window, cache_len)`` classifies as paged only when it tracks both
  probe lengths).  They live one row per lane.  ``gather`` and ``scatter``
  read and write the row of every lane in the decode batch, idle lanes
  included, as the reference does.
* **replicated** leaves have neither; stored once.  ``scatter`` rebinds
  one to the view's tensor, so a fixed :meth:`KVPool.decode_view` (what the
  engine's CUDA graphs read and write) refuses a pool that has one.

Data movement is index-tensor driven (:meth:`row_ids` -> :meth:`gather_rows`
/ :meth:`scatter_rows`), so a CUDA graph reads the ``(W, blocks_per_lane)``
block table staged into its inputs before each replay.  Rows of a lane's
table past its allocation read and write scratch block 0, which is zeroed
again after every scatter.  Siblings that alias a shared prefix put the same
block id in the scatter's index more than once; by the copy-on-write rule
below their copies of it hold identical bytes, so the order of those writes
does not matter.

**Prefix sharing**, as in the reference: blocks are refcounted and indexed by
a *chain hash* of the token ids they cache, ``h_i = hash((h_{i-1},
tokens[i*bs:(i+1)*bs]))`` over Python ``int`` tuples, so the hashes equal the
reference's.  A lane registers its fully covered blocks
(:meth:`register_prefix`); a later admission with the same leading tokens
aliases the longest indexed run (:meth:`match_prefix`, :meth:`admit_prefix`,
:meth:`alias`) and skips prefill for it.  Only full blocks whose content is
never rewritten are indexed (the block holding a lane's decode frontier
stays private).  ``release`` decrements refcounts and frees a block only at
zero, and its index entry dies with it.  Retired lanes keep their blocks
indexed until block pressure harvests them.

Invariant relied on for identity with the dense engine: models write cache
content only at positions ``< position`` and mask reads beyond it, and fresh
cache content is zero, so zero-filled growth blocks are indistinguishable
from a dense slot's untouched tail.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["KVPool", "LeafSpec", "probe_cache_layout"]

_PROBE_BATCHES = (3, 5, 7, 11, 13)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Structural classification of one cache leaf."""

    path: str
    kind: str  # "paged" | "lane" | "replicated"
    batch_axis: int | None
    length_axis: int | None


def _keystr(keys: tuple[str, ...]) -> str:
    return "".join(f"['{k}']" for k in keys)


def flatten_cache(tree: dict, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], torch.Tensor]:
    """The leaves of a (nested) cache dict, keyed by their key path."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flatten_cache(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def unflatten_cache(leaves: dict[tuple[str, ...], torch.Tensor]) -> dict:
    """Inverse of :func:`flatten_cache`."""
    tree: dict = {}
    for (*parents, last), val in leaves.items():
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = val
    return tree


def probe_cache_layout(init_cache, cache_len: int, block_size: int) -> dict[str, LeafSpec]:
    """Classify every leaf of the cache dict ``init_cache(batch, length)`` by
    which of its axes scale with the probe's batch and length.  Keyed by the
    leaf's path in ``keystr`` form."""
    length_b = block_size if block_size != cache_len else max(1, cache_len // 2)
    if length_b == cache_len:
        raise ValueError(f"cache_len={cache_len} too small to probe a paged layout")
    batches = [b for b in _PROBE_BATCHES if b not in (cache_len, length_b)]
    pb_a, pb_b = batches[0], batches[1]
    shapes_a = {_keystr(k): tuple(t.shape) for k, t in flatten_cache(init_cache(pb_a, cache_len)).items()}
    shapes_b = {_keystr(k): tuple(t.shape) for k, t in flatten_cache(init_cache(pb_b, length_b)).items()}
    if shapes_a.keys() != shapes_b.keys():
        raise ValueError("init_cache structure changes with (batch, length); cannot page it")
    specs = {}
    for key, sa in shapes_a.items():
        sb = shapes_b[key]
        if len(sa) != len(sb):
            raise ValueError(f"cache leaf {key} changes rank with (batch, length)")
        batch_axis = next((i for i in range(len(sa)) if sa[i] == pb_a and sb[i] == pb_b), None)
        length_axis = None
        if batch_axis is not None:
            length_axis = next(
                (i for i in range(len(sa)) if i != batch_axis and sa[i] == cache_len and sb[i] == length_b),
                None,
            )
        if batch_axis is None:
            kind = "replicated"
        elif length_axis is None:
            kind = "lane"
        else:
            kind = "paged"
        specs[key] = LeafSpec(key, kind, batch_axis, length_axis)
    return specs


class KVPool:
    """Paged KV storage: block pool + per-lane block tables + lane state.

    ``lanes`` bounds concurrent decode residents (the engine's ``max_batch``);
    ``n_blocks`` bounds total live cache tokens (``n_blocks * block_size``).
    With the defaults (``block_size=None``) the pool is the seed engine's
    dense ``init_cache(lanes, cache_len)`` layout.
    """

    def __init__(self, model, *, lanes: int, cache_len: int,
                 block_size: int | None = None, n_blocks: int | None = None):
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        self.lanes = int(lanes)
        self.cache_len = int(cache_len)
        self.block_size = int(block_size) if block_size else self.cache_len
        if self.cache_len % self.block_size:
            raise ValueError(f"cache_len={cache_len} not divisible by block_size={self.block_size}")
        self.blocks_per_lane = self.cache_len // self.block_size
        self.n_blocks = int(n_blocks) if n_blocks else self.lanes * self.blocks_per_lane
        if self.n_blocks < self.blocks_per_lane:
            raise ValueError(f"n_blocks={self.n_blocks} cannot back even one full lane "
                             f"({self.blocks_per_lane} blocks)")
        self.specs = probe_cache_layout(model.init_cache, self.cache_len, self.block_size)
        for spec in self.specs.values():
            if spec.kind == "paged" and spec.length_axis != spec.batch_axis + 1:
                raise ValueError(f"paged cache leaf {spec.path}: its length axis must follow its batch axis")
        kinds = {spec.kind for spec in self.specs.values()}
        # Block pool: the batch axis indexes blocks, id 0 the always-zero scratch block.
        per_block = flatten_cache(model.init_cache(self.n_blocks + 1, self.block_size)) if "paged" in kinds else {}
        per_lane = flatten_cache(model.init_cache(self.lanes, self.cache_len)) if kinds - {"paged"} else {}
        # keystr path -> key path, to rebuild the model's tree.
        self._paths = {_keystr(k): k for k in (per_block or per_lane)}
        self._store = {key: (per_block if self.specs[key].kind == "paged" else per_lane)[k]
                       for key, k in self._paths.items()}
        self._device = next(iter(self._store.values())).device
        # Free list popped from the tail: ids come out ascending (1, 2, ...).
        self._free = list(range(self.n_blocks, 0, -1))
        self._tables: list[list[int]] = [[] for _ in range(self.lanes)]
        # Finished lanes whose blocks stay readable until an allocation needs them.
        self._retired: set[int] = set()
        # Per-block refcounts (index 0 = scratch, never allocated).
        self._rc = [0] * (self.n_blocks + 1)
        self._lane_tokens = [0] * self.lanes
        # Prefix index: chain hash -> block id, and the reverse map so freeing a
        # block drops its entry.
        self._prefix_index: dict[int, int] = {}
        self._block_hash: dict[int, int] = {}
        self._prefix_lookups = 0
        self._prefix_hits = 0
        self._prefix_hit_tokens = 0

    # -- block accounting ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def block_table(self, lane: int) -> tuple[int, ...]:
        return tuple(self._tables[lane])

    def lane_capacity(self, lane: int) -> int:
        return len(self._tables[lane]) * self.block_size

    def blocks_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_size))

    def block_refcount(self, blk: int) -> int:
        return self._rc[blk]

    def lane_holds_shared(self, lane: int) -> bool:
        """True if any block in ``lane``'s table is aliased by another lane."""
        return any(self._rc[blk] > 1 for blk in self._tables[lane])

    @property
    def retired_blocks(self) -> int:
        """Blocks a harvest would free: refcount-1 blocks of retired lanes."""
        return sum(1 for lane in self._retired for blk in self._tables[lane] if self._rc[blk] == 1)

    def retire(self, lane: int) -> None:
        """Mark a finished lane reclaimable without scrubbing it yet."""
        if self._tables[lane]:
            self._retired.add(lane)

    def _harvest(self, need: int) -> None:
        """Reclaim retired lanes (lowest lane id first) until ``need`` blocks are free."""
        while len(self._free) < need and self._retired:
            self.release(min(self._retired))

    def can_fit(self, n_tokens: int) -> bool:
        """Could a fresh lane for ``n_tokens`` be admitted right now?"""
        return self.blocks_needed(n_tokens) <= len(self._free) + self.retired_blocks

    def ensure(self, lane: int, n_tokens: int) -> bool:
        """Grow ``lane``'s table to cover ``n_tokens``; False if the pool is dry.
        New blocks are zeroed, like a dense slot's untouched tail."""
        table = self._tables[lane]
        need = self.blocks_needed(n_tokens) - len(table)
        if need <= 0:
            return True
        if need > len(self._free):
            self._harvest(need)
        if need > len(self._free):
            return False
        for _ in range(need):
            blk = self._free.pop()
            self._rc[blk] = 1
            self._zero_block(blk)
            table.append(blk)
        return True

    def note_tokens(self, lane: int, n_tokens: int) -> None:
        """Record how many token slots ``lane`` actually uses (monotone)."""
        cap = len(self._tables[lane]) * self.block_size
        self._lane_tokens[lane] = min(max(self._lane_tokens[lane], n_tokens), cap)

    def release(self, lane: int) -> int:
        """Drop ``lane``'s claim on its blocks (finish or preemption).  Each
        block's refcount is decremented and only blocks reaching zero are
        freed; returns how many were."""
        self._retired.discard(lane)
        dropped = []
        for blk in self._tables[lane]:
            self._rc[blk] -= 1
            if self._rc[blk] == 0:
                dropped.append(blk)
                h = self._block_hash.pop(blk, None)
                if h is not None and self._prefix_index.get(h) == blk:
                    del self._prefix_index[h]
        self._free.extend(reversed(dropped))  # pop() reuses the lowest id first
        self._tables[lane] = []
        self._lane_tokens[lane] = 0
        return len(dropped)

    # -- prefix sharing -----------------------------------------------------
    def _chain_hashes(self, tokens) -> list[int]:
        """Chain hash per *fully covered* block of ``tokens`` (token ids)."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        out: list[int] = []
        h = 0x9E3779B9  # fixed chain seed
        for i in range(len(toks) // bs):
            h = hash((h, tuple(toks[i * bs:(i + 1) * bs])))
            out.append(h)
        return out

    def match_prefix(self, tokens, *, peek: bool = False) -> list[int]:
        """Longest indexed block run caching a prefix of ``tokens``, in prefix
        order.  ``peek=True`` leaves the hit-rate counters alone (the
        router's affinity probes)."""
        run: list[int] = []
        for h in self._chain_hashes(tokens):
            blk = self._prefix_index.get(h)
            if blk is None:
                break
            run.append(blk)
        if not peek:
            self._prefix_lookups += 1
            if run:
                self._prefix_hits += 1
                self._prefix_hit_tokens += len(run) * self.block_size
        return run

    def register_prefix(self, lane: int, tokens) -> int:
        """Index ``lane``'s blocks that fully cover a prefix of ``tokens``
        (first registration of a chain hash wins); returns how many are
        shareable."""
        n = 0
        for h, blk in zip(self._chain_hashes(tokens), self._tables[lane]):
            if h not in self._prefix_index:
                self._prefix_index[h] = blk
                self._block_hash[blk] = h
            n += 1
        return n

    def admit_prefix(self, lane: int, tokens) -> int:
        """Release ``lane``'s previous tenant and seed it with the longest
        cached prefix of ``tokens``, atomically: the match is reserved
        before the release, since the outgoing tenant may own it.  Returns
        the prefix tokens served from cache."""
        matched = self.match_prefix(tokens)
        for blk in matched:
            self._rc[blk] += 1  # reserve against the release below
        self.release(lane)
        self._tables[lane] = list(matched)
        self._lane_tokens[lane] = len(matched) * self.block_size
        return len(matched) * self.block_size

    def alias(self, lane: int, blocks) -> None:
        """Seed a fresh lane's table with shared ``blocks`` (incref each)."""
        table = self._tables[lane]
        if table:
            raise ValueError(f"alias() requires an empty table (lane {lane})")
        for blk in blocks:
            if self._rc[blk] < 1:
                raise ValueError(f"alias() of unallocated block {blk}")
            self._rc[blk] += 1
            table.append(blk)
        self._lane_tokens[lane] = len(table) * self.block_size

    def reset_lane_state(self, lane: int) -> None:
        """Zero ``lane``'s row of every lane leaf (fresh-cache state)."""
        for key, spec in self.specs.items():
            if spec.kind == "lane":
                self._store[key].select(spec.batch_axis, lane).zero_()

    @property
    def shared_blocks(self) -> int:
        """Blocks currently aliased by more than one lane table."""
        return sum(1 for blk in range(1, self.n_blocks + 1) if self._rc[blk] > 1)

    def stats(self) -> dict:
        alloc_slots = sum(len(t) for t in self._tables) * self.block_size
        used_slots = min(sum(self._lane_tokens), alloc_slots)
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "free_blocks": self.free_blocks,
            "retired_blocks": self.retired_blocks,
            "used_blocks": self.used_blocks,
            "utilization": self.used_blocks / self.n_blocks,
            "fragmentation": 1.0 - used_slots / alloc_slots if alloc_slots else 0.0,
            "shared_blocks": self.shared_blocks,
            "prefix_lookups": self._prefix_lookups,
            "prefix_hits": self._prefix_hits,
            "prefix_hit_tokens": self._prefix_hit_tokens,
            "prefix_hit_rate": self._prefix_hits / self._prefix_lookups if self._prefix_lookups else 0.0,
            "lanes": self.lanes,
            "lanes_used": sum(1 for t in self._tables if t),
        }

    # -- data movement ------------------------------------------------------
    def _zero_block(self, blk: int) -> None:
        for key, spec in self.specs.items():
            if spec.kind == "paged":
                self._store[key].select(spec.batch_axis, blk).zero_()

    def row_ids(self, lane_ids) -> tuple[np.ndarray, np.ndarray]:
        """(block table, lane id) per row, on the host: a ``(W,
        blocks_per_lane)`` table of block ids, scratch block 0 past each
        lane's allocation, and the ``(W,)`` lane ids."""
        blocks = np.zeros((len(lane_ids), self.blocks_per_lane), dtype=np.int64)
        for row, lane in enumerate(lane_ids):
            table = self._tables[lane]
            blocks[row, :len(table)] = table
        return blocks, np.asarray(lane_ids, dtype=np.int64)

    def _rows(self, lane_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`row_ids` as index tensors on the pool's device."""
        return tuple(torch.from_numpy(ids).to(self._device) for ids in self.row_ids(lane_ids))

    def _flat(self, cache: dict) -> dict[str, torch.Tensor]:
        return {_keystr(k): t for k, t in flatten_cache(cache).items()}

    def _blocked(self, spec: LeafSpec, t: torch.Tensor) -> torch.Tensor:
        """A (…, rows, cache_len, …) leaf seen as (…, rows x blocks_per_lane,
        block_size, …): the pool's block layout, without a copy."""
        b = spec.batch_axis
        shape = t.shape
        return t.view(*shape[:b], shape[b] * self.blocks_per_lane, self.block_size, *shape[b + 2:])

    def admit(self, lane: int, cache1: dict) -> None:
        """Write a batch-1 prefill cache (the model's tree, full ``cache_len``
        length) into ``lane``'s allocated blocks and lane-state row.  Content
        beyond the lane's blocks is zero in ``cache1`` by the masking
        invariant (module docstring)."""
        leaves = self._flat(cache1)
        table = self._tables[lane]
        ids = torch.tensor(table, dtype=torch.int64).to(self._device) if table else None
        for key, spec in self.specs.items():
            if spec.kind == "replicated":
                continue  # the reference keeps the pool's value
            leaf = leaves[key]
            if spec.kind == "lane":
                self._store[key].select(spec.batch_axis, lane).copy_(leaf.select(spec.batch_axis, 0))
            elif ids is not None:
                chunks = self._blocked(spec, leaf.contiguous()).narrow(spec.batch_axis, 0, len(table))
                self._store[key].index_copy_(spec.batch_axis, ids, chunks)

    def gather(self, lane_ids) -> dict:
        """The dense decode view (a copy, in the model's tree) for
        ``lane_ids``.  Table rows past a lane's allocation read the zero
        scratch block; lane leaves read each lane's own row."""
        return self.gather_rows(*self._rows(list(lane_ids)))

    def decode_view(self, rows: int) -> dict:
        """An uninitialised dense view of ``rows`` rows (the model's tree), for
        :meth:`gather_rows` to fill in place.  Replicated leaves have no rows."""
        if any(spec.kind == "replicated" for spec in self.specs.values()):
            raise NotImplementedError("a replicated cache leaf has no rows to gather into a fixed view")
        out = {}
        for key, spec in self.specs.items():
            arr = self._store[key]
            shape = list(arr.shape)
            shape[spec.batch_axis] = rows
            if spec.kind == "paged":
                shape[spec.length_axis] = self.cache_len
            out[self._paths[key]] = torch.empty(shape, dtype=arr.dtype, device=arr.device)
        return unflatten_cache(out)

    def gather_rows(self, blocks: torch.Tensor, lanes: torch.Tensor, out: dict | None = None) -> dict:
        """:meth:`gather` from index tensors (:meth:`row_ids` on the device:
        ``blocks`` (W, blocks_per_lane), ``lanes`` (W,)), into the leaves of
        ``out`` (a :meth:`decode_view`) in place when given."""
        dst = self._flat(out) if out is not None else {}
        idx = blocks.reshape(-1)
        w = lanes.shape[0]
        res = {}
        for key, spec in self.specs.items():
            arr = self._store[key]
            if spec.kind == "replicated":
                res[self._paths[key]] = arr
            elif spec.kind == "lane":
                res[self._paths[key]] = torch.index_select(arr, spec.batch_axis, lanes, out=dst.get(key))
            else:
                b = spec.batch_axis
                view = dst.get(key)
                if view is None:
                    shape = list(arr.shape)
                    shape[b:b + 2] = [w, self.cache_len]
                    view = torch.empty(shape, dtype=arr.dtype, device=arr.device)
                torch.index_select(arr, b, idx, out=self._blocked(spec, view))
                res[self._paths[key]] = view
        return unflatten_cache(res)

    def scatter(self, lane_ids, cache: dict) -> None:
        """Write an updated dense view (the model's tree) back.  Table rows
        past a lane's allocation went to scratch block 0, which is zeroed
        again afterwards."""
        self.scatter_rows(*self._rows(list(lane_ids)), cache)

    def scatter_rows(self, blocks: torch.Tensor, lanes: torch.Tensor, cache: dict) -> None:
        """:meth:`scatter` from index tensors.  Only a replicated leaf is
        rebound (to the view's tensor); every other store tensor is written in
        place and keeps its address."""
        leaves = self._flat(cache)
        idx = blocks.reshape(-1)
        touched_scratch = False
        for key, spec in self.specs.items():
            if spec.kind == "replicated":
                self._store[key] = leaves[key]
            elif spec.kind == "lane":
                self._store[key].index_copy_(spec.batch_axis, lanes, leaves[key])
            else:
                src = self._blocked(spec, leaves[key].contiguous())
                self._store[key].index_copy_(spec.batch_axis, idx, src)
                touched_scratch = True
        if touched_scratch:
            self._zero_block(0)
