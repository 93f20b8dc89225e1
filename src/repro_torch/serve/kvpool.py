"""KV cache storage for the serving engine: the dense layout of ``repro/serve/kvpool.py``.

The reference pool is block-allocated; with ``block_size=None`` it degenerates
to one ``cache_len``-sized block per lane, which is the layout this port keeps
so far.  The block bookkeeping is the reference's (a free list, per-lane block
tables, lazy reclaim of retired lanes, block 0 as an always-zero scratch
block), so admission decisions and pool statistics match it; refcounts wait
for prefix sharing, since without it every block has one owner.  Storage
is the model's own cache dict, ``{"k", "v"}`` of shape
``(n_layers, n_blocks + 1, cache_len, KV, hd)``: the batch axis (1) indexes
blocks.  Paging and prefix sharing raise ``NotImplementedError`` until the
serving tier is ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["KVPool"]

_BATCH_AXIS = 1  # TransformerLM caches are (n_layers, B, T, KV, hd)


class KVPool:
    """Dense KV storage: one cache_len block per lane, plus scratch block 0."""

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
        self._store = model.init_cache(self.n_blocks + 1, self.cache_len)
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
        for arr in self._store.values():
            arr.select(_BATCH_AXIS, blk).zero_()

    def _block_ids(self, lane_ids) -> torch.Tensor:
        """One block id per lane (scratch 0 for a lane with no table)."""
        ids = np.zeros(len(lane_ids), dtype=np.int64)
        for row, lane in enumerate(lane_ids):
            if self._tables[lane]:
                ids[row] = self._tables[lane][0]
        return torch.from_numpy(ids).to(self._device)

    def admit(self, lane: int, cache1: dict) -> None:
        """Write a batch-1 prefill cache (full ``cache_len`` length) into
        ``lane``'s block."""
        blk = self._tables[lane][0]
        for key, arr in self._store.items():
            arr.select(_BATCH_AXIS, blk).copy_(cache1[key].select(_BATCH_AXIS, 0))

    def gather(self, lane_ids) -> dict:
        """The dense decode view (a copy) for ``lane_ids``; lanes without a
        block read the zero scratch block."""
        idx = self._block_ids(list(lane_ids))
        return {key: arr.index_select(_BATCH_AXIS, idx) for key, arr in self._store.items()}

    def scatter(self, lane_ids, cache: dict) -> None:
        """Write an updated dense view back.  Lanes without a block wrote
        into scratch block 0, which is re-zeroed afterwards."""
        idx = self._block_ids(list(lane_ids))
        for key, arr in self._store.items():
            arr.index_copy_(_BATCH_AXIS, idx, cache[key])
        self._zero_block(0)
