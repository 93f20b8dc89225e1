"""Cache storage for the serving engine: the dense layout of ``repro/serve/kvpool.py``.

The reference pool is block-allocated; with ``block_size=None`` it degenerates
to one ``cache_len``-sized block per lane, which is the layout this port keeps
so far.  The block bookkeeping is the reference's (a free list, per-lane block
tables, lazy reclaim of retired lanes, block 0 as an always-zero scratch
block), so admission decisions and pool statistics match it; refcounts wait
for prefix sharing, since without it every block has one owner.

Cache leaves are classified structurally, as the reference's
``probe_cache_layout`` does: ``model.init_cache`` is probed at two (batch,
length) points and each leaf's scaling axes decide its kind.  A cache is a
dict of tensors, nested or not (Hymba's is ``{"layer{i}": {"k", "v",
"ssm"}}``); each leaf is named by its path in the reference's ``keystr``
form (``"['layer1']['k']"``), and ``gather`` / ``scatter`` / ``admit`` take
and return the model's own tree.

* **paged** leaves have a batch axis and a length axis that tracks
  ``cache_len`` exactly (k/v token caches).  They live in the block store,
  whose batch axis indexes blocks: ``(n_blocks + 1)`` rows, row 0 the scratch
  block.
* **lane** leaves have a batch axis but no length axis that tracks
  ``cache_len`` (the RWKV6 wkv/x1/x2 and Hymba SSM recurrent state, and
  sliding-window rings shorter than ``cache_len``).  They live one row per
  lane.  ``gather`` and ``scatter`` read and write the row of every lane in
  the decode batch, idle lanes included, as the reference does.
* **replicated** leaves have neither; stored once.  ``scatter`` rebinds
  one to the view's tensor, so a fixed :meth:`KVPool.decode_view` (what the
  engine's CUDA graphs read and write) refuses a pool that has one.

Paging and prefix sharing raise ``NotImplementedError`` until the serving
tier is ported.
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
    """Dense cache storage: one cache_len block per lane plus scratch block 0,
    and one row per lane for recurrent state."""

    def __init__(self, model, *, lanes: int, cache_len: int,
                 block_size: int | None = None, n_blocks: int | None = None):
        if block_size is not None or n_blocks is not None:
            raise NotImplementedError("paged KV storage (block_size / n_blocks) is not ported yet")
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        self.lanes = int(lanes)
        self.cache_len = int(cache_len)
        self.block_size = self.cache_len
        self.blocks_per_lane = 1
        self.n_blocks = self.lanes
        self.specs = probe_cache_layout(model.init_cache, self.cache_len, self.block_size)
        kinds = {spec.kind for spec in self.specs.values()}
        per_block = flatten_cache(model.init_cache(self.n_blocks + 1, self.cache_len)) if "paged" in kinds else {}
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
        self._lane_tokens = [0] * self.lanes

    # -- block accounting ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def blocks_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_size))

    @property
    def retired_blocks(self) -> int:
        return sum(len(self._tables[lane]) for lane in self._retired)

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
            self._zero_block(blk)
            table.append(blk)
        return True

    def note_tokens(self, lane: int, n_tokens: int) -> None:
        """Record how many token slots ``lane`` actually uses (monotone)."""
        cap = len(self._tables[lane]) * self.block_size
        self._lane_tokens[lane] = min(max(self._lane_tokens[lane], n_tokens), cap)

    def release(self, lane: int) -> int:
        """Drop ``lane``'s claim on its blocks; returns how many were freed."""
        self._retired.discard(lane)
        dropped = self._tables[lane]
        self._free.extend(reversed(dropped))  # pop() reuses the lowest id first
        self._tables[lane] = []
        self._lane_tokens[lane] = 0
        return len(dropped)

    def reset_lane_state(self, lane: int) -> None:
        """Zero ``lane``'s row of every lane leaf (fresh-cache state)."""
        for key, spec in self.specs.items():
            if spec.kind == "lane":
                self._store[key].select(spec.batch_axis, lane).zero_()

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
            "lanes": self.lanes,
            "lanes_used": sum(1 for t in self._tables if t),
        }

    # -- data movement ------------------------------------------------------
    def _zero_block(self, blk: int) -> None:
        for key, spec in self.specs.items():
            if spec.kind == "paged":
                self._store[key].select(spec.batch_axis, blk).zero_()

    def row_ids(self, lane_ids) -> tuple[np.ndarray, np.ndarray]:
        """(block id, lane id) per row, on the host: block 0 (scratch) for a
        lane with no table."""
        blocks = np.zeros(len(lane_ids), dtype=np.int64)
        for row, lane in enumerate(lane_ids):
            if self._tables[lane]:
                blocks[row] = self._tables[lane][0]
        return blocks, np.asarray(lane_ids, dtype=np.int64)

    def _rows(self, lane_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`row_ids` as index tensors on the pool's device."""
        return tuple(torch.from_numpy(ids).to(self._device) for ids in self.row_ids(lane_ids))

    def _flat(self, cache: dict) -> dict[str, torch.Tensor]:
        return {_keystr(k): t for k, t in flatten_cache(cache).items()}

    def admit(self, lane: int, cache1: dict) -> None:
        """Write a batch-1 prefill cache (the model's tree, full ``cache_len``
        length) into ``lane``'s block and lane-state row."""
        leaves = self._flat(cache1)
        for key, spec in self.specs.items():
            if spec.kind == "replicated":
                continue  # the reference keeps the pool's value
            row = self._tables[lane][0] if spec.kind == "paged" else lane
            self._store[key].select(spec.batch_axis, row).copy_(leaves[key].select(spec.batch_axis, 0))

    def gather(self, lane_ids) -> dict:
        """The dense decode view (a copy, in the model's tree) for
        ``lane_ids``.  Paged leaves of a lane without a block read the zero
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
            out[self._paths[key]] = torch.empty(shape, dtype=arr.dtype, device=arr.device)
        return unflatten_cache(out)

    def gather_rows(self, blocks: torch.Tensor, lanes: torch.Tensor, out: dict | None = None) -> dict:
        """:meth:`gather` from index tensors (:meth:`row_ids` on the device),
        into the leaves of ``out`` (a :meth:`decode_view`) in place when given."""
        dst = self._flat(out) if out is not None else {}
        res = {}
        for key, spec in self.specs.items():
            arr = self._store[key]
            if spec.kind == "replicated":
                res[self._paths[key]] = arr
            else:
                idx = blocks if spec.kind == "paged" else lanes
                res[self._paths[key]] = torch.index_select(arr, spec.batch_axis, idx, out=dst.get(key))
        return unflatten_cache(res)

    def scatter(self, lane_ids, cache: dict) -> None:
        """Write an updated dense view (the model's tree) back.  Paged rows of
        lanes without a block went to scratch block 0, which is re-zeroed
        afterwards."""
        self.scatter_rows(*self._rows(list(lane_ids)), cache)

    def scatter_rows(self, blocks: torch.Tensor, lanes: torch.Tensor, cache: dict) -> None:
        """:meth:`scatter` from index tensors.  Only a replicated leaf is
        rebound (to the view's tensor); every other store tensor is written in
        place and keeps its address."""
        leaves = self._flat(cache)
        touched_scratch = False
        for key, spec in self.specs.items():
            if spec.kind == "replicated":
                self._store[key] = leaves[key]
            elif spec.kind == "lane":
                self._store[key].index_copy_(spec.batch_axis, lanes, leaves[key])
            else:
                self._store[key].index_copy_(spec.batch_axis, blocks, leaves[key])
                touched_scratch = True
        if touched_scratch:
            self._zero_block(0)
