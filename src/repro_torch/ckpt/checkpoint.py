"""Atomic checkpoints with an async writer and keep-k GC, ported from
``repro/ckpt/checkpoint.py``, in the reference's on-disk format:

  * one ``.npy`` file per leaf, keyed by its tree path (``params/emb/embed``,
    ``opt/m/...``, ``opt/step``) with ``/`` written as ``__``, and a
    ``manifest.json`` holding the step, the sorted keys and ``extra``;
  * written to ``step_N.tmp/`` and renamed to ``step_N/`` once every array
    and the manifest are on disk (the commit point); GC removes torn
    ``.tmp`` directories and all but the newest ``keep`` steps;
  * ``save_async`` copies the tree to host memory at once and writes it on a
    background thread; ``wait()`` joins it and raises what it raised.

So a checkpoint written by either package restores in the other.  Two
dtypes need care.  The reference's bf16 leaves are written through
ml_dtypes as raw 2-byte words (``descr '<V2'``): :meth:`restore` reads them
as int16 and reinterprets the bits as ``torch.bfloat16``.  The port writes a
bf16 leaf as f32 (every bf16 value is exact there), which the reference's
``restore`` casts back with ``astype(leaf.dtype)``.  A tied model's
``emb.embed_t`` is derived from ``embed``: it is never saved, and a restore
into a tree that holds one rebuilds it.

Sharded state (DTensor leaves, ``dist.sharding``) is saved in the same
format: every rank gathers each full array (a collective, so every rank
calls ``save`` / ``save_async`` at the same steps), rank 0 alone writes, and
every rank leaves ``save`` / ``wait`` only once the step is committed (a
barrier of the default group).  ``restore(..., placements=)`` places each
array as it loads, as the reference's ``shardings=`` does: every rank reads
the full array and keeps its own shard, so a checkpoint written on one mesh
restores onto any other, or onto none.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..optim.adamw import DERIVED

_MANIFEST = "manifest.json"


def _items(tree, prefix: str = ""):
    """(path, leaf) of every leaf of a tree of dicts and NamedTuples, derived leaves left out."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    for key, value in tree.items():
        if key in DERIVED:
            continue
        if isinstance(value, dict) or hasattr(value, "_asdict"):
            yield from _items(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _to_numpy(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array (bf16 widened to f32; a DTensor's full array,
    gathered); ``copy`` never shares memory with the leaf, which the trainer
    goes on updating in place."""
    if isinstance(leaf, DTensor):
        with torch.no_grad():
            leaf, copy = leaf.full_tensor(), False
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=copy)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # the reference's ml_dtypes bf16
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def _file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _sharded(tree) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in _items(tree))


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending_barrier = False  # a sharded save_async whose commit every rank awaits in wait()

    # -- discovery ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                if (p / _MANIFEST).exists():  # committed only
                    out.append(int(p.name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None) -> None:
        """Blocking atomic save of a tree of tensors (or numpy arrays); of
        DTensors, a collective written by rank 0."""
        sharded = _sharded(tree)
        flat = {key: _to_numpy(leaf) for key, leaf in _items(tree)}
        if _rank() == 0:
            self._write(step, flat, extra)
        if sharded:
            dist.barrier()

    def _write(self, step: int, flat: dict[str, np.ndarray], extra: dict | None) -> None:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for key, arr in flat.items():
            np.save(tmp / _file(key), arr)
        manifest = {"step": step, "keys": sorted(flat), "extra": extra or {}}
        (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # the commit point
        self._gc()

    def save_async(self, step: int, tree, *, extra: dict | None = None) -> None:
        """Copy to host memory now; write on a background thread."""
        self.wait()
        self._pending_barrier = _sharded(tree)
        host = {key: _to_numpy(leaf, copy=True) for key, leaf in _items(tree)}  # device -> host now
        if _rank() != 0:
            return

        def work():
            try:
                self._write(step, host, extra)
            except BaseException as e:  # noqa: BLE001 — surfaced at the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending_barrier:
            self._pending_barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------
    def restore(self, step: int, like, *, placements=None):
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf with ``like``'s shape (checked), dtype and device.  NamedTuples
        in ``like`` come back as the same type.

        ``placements``: an optional matching tree whose leaves are
        ``(DeviceMesh, placements)`` pairs (``dist.sharding.placement_tree``):
        each array loads as a DTensor on them, every rank keeping its own
        shard of the full array it reads, so restore works on any mesh.
        Returns (tree, extra)."""
        final = self.dir / f"step_{step}"
        manifest = json.loads((final / _MANIFEST).read_text())
        keys = set(manifest["keys"])

        def load(node, place, prefix: str):
            if hasattr(node, "_asdict"):
                return type(node)(**load(node._asdict(), None if place is None else place._asdict(), prefix))
            out = {}
            for key, leaf in node.items():
                if key in DERIVED:
                    continue
                path = f"{prefix}{key}"
                where = None if place is None else place[key]
                if isinstance(leaf, dict) or hasattr(leaf, "_asdict"):
                    out[key] = load(leaf, where, path + "/")
                    continue
                if path not in keys:
                    raise KeyError(f"checkpoint step {step} missing array {path!r}")
                arr = _from_numpy(np.load(final / _file(path)))
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{path}: checkpoint shape {tuple(arr.shape)} != expected {tuple(leaf.shape)}")
                arr = arr.to(device=leaf.device, dtype=leaf.dtype)
                out[key] = arr if where is None else distribute_tensor(arr, *where, src_data_rank=None)
            if "embed_t" in node:
                embed_t = out["embed"].t().contiguous()
                if place is not None:
                    mesh, target = place["embed_t"]
                    embed_t = embed_t.redistribute(mesh, target)
                out["embed_t"] = embed_t
            return out

        return load(like, placements, ""), manifest["extra"]

    def restore_latest(self, like, *, placements=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, placements=placements)
        return step, tree, extra

    # -- GC -------------------------------------------------------------------
    def _gc(self) -> None:
        for p in self.dir.iterdir():  # torn writes
            if p.name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
