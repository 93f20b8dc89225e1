"""Collective analysis of the port's sharded programs: the counterpart of
``repro/launch/hloanalysis.py``.

The reference parses collectives and their shard byte counts out of a
compiled HLO.  The port has no HLO: DTensor issues its collectives as
``_c10d_functional`` ops (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``, ``broadcast``, and their autograd
twins), each on one rank's local shards.  :class:`CollectiveCounter` is a
``TorchDispatchMode`` that sees those ops as DTensor runs them (it lets the
DTensor-level call pass, so it sees the local ops beneath it) and sums, per
kind, their count and their result bytes per device, under the reference's
keys: ``all-gather_bytes``, ``all-reduce_count``, and so on.
(``CommDebugMode`` counts the collectives but gives no bytes.)
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# _c10d_functional op stem -> the reference's HLO collective name
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_kind(func) -> str | None:
    """The reference's name of a ``_c10d_functional`` collective op, else None."""
    ns = getattr(func, "namespace", "")
    if not ns.startswith("_c10d_functional"):
        return None
    stem = func._schema.name.split("::", 1)[-1]
    return KINDS.get(stem)


def _nbytes(out) -> int:
    leaves = out if isinstance(out, (list, tuple)) else (out,)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def local_call(types) -> bool:
    """Whether a dispatch-mode call is a rank's local op: not a DTensor-level
    call (the mode passes it on to DTensor, which runs the local ops beneath
    it) and not DTensor's sharding propagation on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    return not any(issubclass(t, (DTensor, FakeTensor)) for t in types)


class CollectiveCounter(TorchDispatchMode):
    """Counts and bytes per device of every collective the local ops issue."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = collective_kind(func)
        if kind is not None and local_call(types):
            self.bytes[kind] += _nbytes(out)
            self.counts[kind] += 1
        return out

    def summary(self) -> dict:
        """``{"<kind>_bytes": float, "<kind>_count": int}``, as ``hloanalysis.collective_bytes``."""
        return {**{f"{k}_bytes": v for k, v in self.bytes.items()}, **{f"{k}_count": self.counts[k] for k in self.counts}}
