"""Flat structure-of-arrays decision trees — the compiled selection fast path.

The paper's launcher embeds the decision tree as a handful of nested ``if``
statements (§5.1), so selection costs nanoseconds.  The nested ``_Node``
object graph we train on is the opposite: per-row Python pointer chasing.
:class:`FlatTree` is the deployable middle ground — five parallel arrays
(feature / threshold / left / right / label) laid out in preorder, with a
fully vectorized batch ``predict`` that descends one *frontier level* per
iteration instead of one Python node per row.  Every fitted tree compiles
into this form after ``fit``; it is also deployment blob format v2
(see DESIGN.md §5).

Numpy-only, no imports from the rest of ``repro.core`` (classify/codegen
import *us*, not the other way round).

Copied verbatim from ``repro/core/flattree.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FlatTree"]

_LEAF = -1


@dataclasses.dataclass
class FlatTree:
    """Preorder flat arrays for a binary decision tree.

    ``feature[i] == -1`` marks node ``i`` as a leaf; ``left``/``right`` hold
    child node indices for internal nodes (and ``-1`` on leaves).  ``counts``
    (optional) carries the per-node class-count vectors needed by random
    forests' soft voting.
    """

    feature: np.ndarray  # (n_nodes,) int32, -1 for leaves
    threshold: np.ndarray  # (n_nodes,) float64
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    label: np.ndarray  # (n_nodes,) int32
    n_classes: int
    counts: np.ndarray | None = None  # (n_nodes, n_classes) float64

    def __post_init__(self):
        self.feature = np.asarray(self.feature, dtype=np.int32)
        self.threshold = np.asarray(self.threshold, dtype=np.float64)
        self.left = np.asarray(self.left, dtype=np.int32)
        self.right = np.asarray(self.right, dtype=np.int32)
        self.label = np.asarray(self.label, dtype=np.int32)
        if self.counts is not None:
            self.counts = np.asarray(self.counts, dtype=np.float64)

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    def n_leaves(self) -> int:
        return int((self.feature == _LEAF).sum())

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_node(root, n_classes: int) -> "FlatTree":
        """Compile a nested node graph (``.feature/.threshold/.left/.right/
        .label/.counts`` duck type) into flat arrays, iteratively."""
        feature: list[int] = []
        threshold: list[float] = []
        left: list[int] = []
        right: list[int] = []
        label: list[int] = []
        counts: list[np.ndarray | None] = []

        def alloc(node) -> int:
            idx = len(feature)
            is_leaf = node.left is None
            feature.append(_LEAF if is_leaf else int(node.feature))
            threshold.append(0.0 if is_leaf else float(node.threshold))
            left.append(_LEAF)
            right.append(_LEAF)
            label.append(int(node.label))
            counts.append(getattr(node, "counts", None))
            return idx

        stack = [(root, alloc(root))]
        while stack:
            node, idx = stack.pop()
            if node.left is None:
                continue
            li = alloc(node.left)
            ri = alloc(node.right)
            left[idx], right[idx] = li, ri
            stack.append((node.left, li))
            stack.append((node.right, ri))

        cmat = None
        if all(c is not None for c in counts):
            cmat = np.zeros((len(counts), n_classes))
            for i, c in enumerate(counts):
                cmat[i, : len(c)] = c
        return FlatTree(feature, threshold, left, right, label, n_classes, cmat)

    def to_node(self, node_factory):
        """Reconstruct the nested node graph (for codegen / back-compat)."""
        nodes = [node_factory() for _ in range(self.n_nodes)]
        for i, node in enumerate(nodes):
            node.label = int(self.label[i])
            if self.counts is not None:
                node.counts = self.counts[i].copy()
            if self.feature[i] != _LEAF:
                node.feature = int(self.feature[i])
                node.threshold = float(self.threshold[i])
                node.left = nodes[self.left[i]]
                node.right = nodes[self.right[i]]
        return nodes[0]

    # -- inference ----------------------------------------------------------
    def apply(self, x: np.ndarray) -> np.ndarray:
        """Leaf node index per row — iterative frontier descent.

        Each iteration advances every still-internal row one level, so the
        loop runs ``depth`` times total regardless of batch size (no per-row
        Python recursion).
        """
        x = np.asarray(x, dtype=np.float64)
        idx = np.zeros(len(x), dtype=np.int32)
        while True:
            feat = self.feature[idx]
            live = feat != _LEAF
            if not live.any():
                return idx
            rows = np.nonzero(live)[0]
            at = idx[rows]
            go_left = x[rows, feat[rows]] <= self.threshold[at]
            idx[rows] = np.where(go_left, self.left[at], self.right[at])

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.label[self.apply(x)].astype(int)

    def predict_counts(self, x: np.ndarray) -> np.ndarray:
        """Per-row leaf class-count vectors, normalized (forest soft votes)."""
        if self.counts is None:
            raise ValueError("tree was built without class counts")
        leaf = self.apply(x)
        c = self.counts[leaf]
        return c / np.maximum(c.sum(axis=1, keepdims=True), 1e-12)

    # -- serialization (deployment blob format v2) ---------------------------
    def to_dict(self) -> dict:
        blob = {
            "format": "flat",
            "n_classes": int(self.n_classes),
            "feature": self.feature.tolist(),
            "threshold": self.threshold.tolist(),
            "left": self.left.tolist(),
            "right": self.right.tolist(),
            "label": self.label.tolist(),
        }
        if self.counts is not None:
            blob["counts"] = self.counts.tolist()
        return blob

    @staticmethod
    def from_dict(blob: dict) -> "FlatTree":
        tree = FlatTree(
            feature=blob["feature"],
            threshold=blob["threshold"],
            left=blob["left"],
            right=blob["right"],
            label=blob["label"],
            n_classes=int(blob["n_classes"]),
            counts=blob.get("counts"),
        )
        tree.validate()
        return tree

    def validate(self) -> None:
        """Structural sanity: child indices in range, leaves consistent, no
        cycles — a corrupt blob must fail here, not hang ``predict``."""
        n = self.n_nodes
        if not (len(self.threshold) == len(self.left) == len(self.right) == len(self.label) == n):
            raise ValueError("flat tree arrays have mismatched lengths")
        if n == 0:
            raise ValueError("flat tree is empty")
        internal = self.feature != _LEAF
        parents = np.nonzero(internal)[0]
        kids = np.concatenate([self.left[parents], self.right[parents]])
        if kids.size and (kids.min() < 0 or kids.max() >= n):
            raise ValueError("flat tree child index out of range")
        # Preorder property: children strictly follow their parent, so every
        # root-to-leaf walk has strictly increasing indices (terminates), and
        # each node is the child of at most one parent.
        if np.any(self.left[parents] <= parents) or np.any(self.right[parents] <= parents):
            raise ValueError("flat tree child index does not follow its parent (cycle?)")
        if kids.size != np.unique(kids).size:
            raise ValueError("flat tree node referenced by multiple parents")
        if np.any(self.left[~internal] != _LEAF) or np.any(self.right[~internal] != _LEAF):
            raise ValueError("flat tree leaf with children")
        if self.counts is not None and self.counts.shape != (n, self.n_classes):
            raise ValueError(
                f"flat tree counts shape {self.counts.shape} != ({n}, {self.n_classes})"
            )

    def max_leaf_label(self) -> int:
        """Largest label reachable at a leaf (for deployment validation)."""
        leaves = self.feature == _LEAF
        return int(self.label[leaves].max())
