"""Decision-tree serialization + nested-if code generation.

The paper integrates the trained decision tree into the SYCL launcher as a
series of nested ``if`` statements (§5.1).  We do the same: a fitted
``DecisionTreeClassifier`` can be (a) round-tripped through JSON (what the
deployment artifact stores) and (b) emitted as standalone Python source with
zero dependencies — the literal launcher embedding.

Two interchangeable JSON tree formats (DESIGN.md §5):
  v1 ``{"n_classes", "root": {...nested...}}`` — recursive dicts, what seed
     deployments shipped; still read forever.
  v2 ``{"n_classes", "format": "flat", "feature": [...], ...}`` — the
     :class:`FlatTree` structure-of-arrays, what ``Deployment.save`` now
     emits (compact, loads straight into the vectorized predict path).

Copied from ``repro/core/codegen.py``; ``bundle_to_python`` (the
multi-device launcher) joins with bundles.
"""
from __future__ import annotations

from .classify import DecisionTreeClassifier, _Node
from .dataset import FEATURE_NAMES
from .flattree import FlatTree


def tree_to_dict(tree: DecisionTreeClassifier) -> dict:
    """v1 nested-dict serialization (kept for back-compat round-trips)."""
    if not isinstance(tree, DecisionTreeClassifier):
        raise TypeError(
            f"only decision trees are shippable launcher classifiers, got {type(tree).__name__}"
        )

    def rec(node: _Node) -> dict:
        if node.left is None:
            return {"label": int(node.label)}
        return {
            "feature": int(node.feature),
            "threshold": float(node.threshold),
            "left": rec(node.left),
            "right": rec(node.right),
        }

    return {"n_classes": tree.n_classes_, "root": rec(tree.root_)}


def tree_to_flat_dict(tree: DecisionTreeClassifier) -> dict:
    """v2 flat-array serialization — ships arrays, not recursive dicts."""
    if not isinstance(tree, DecisionTreeClassifier):
        raise TypeError(
            f"only decision trees are shippable launcher classifiers, got {type(tree).__name__}"
        )
    blob = tree._ensure_flat().to_dict()
    blob.pop("counts", None)  # launcher blobs ship labels only
    return blob


def dict_to_tree(blob: dict) -> DecisionTreeClassifier:
    """Parse either tree format back into a classifier.

    v2 blobs load directly into the flat fast path; the nested node graph is
    reconstructed too so codegen (``tree_to_python``) keeps working.
    """
    tree = DecisionTreeClassifier()
    tree.n_classes_ = int(blob["n_classes"])
    if blob.get("format") == "flat":
        tree.flat_ = FlatTree.from_dict(blob)
        tree.root_ = tree.flat_.to_node(_Node)
        return tree
    if "root" not in blob:
        raise ValueError(f"unrecognized tree blob (keys: {sorted(blob)})")

    def rec(d: dict) -> _Node:
        node = _Node()
        if "label" in d:
            node.label = int(d["label"])
            return node
        node.feature = int(d["feature"])
        node.threshold = float(d["threshold"])
        node.left = rec(d["left"])
        node.right = rec(d["right"])
        node.label = 0
        return node

    tree.root_ = rec(blob["root"])
    tree.flat_ = FlatTree.from_node(tree.root_, tree.n_classes_)
    return tree


def tree_to_python(
    tree: DecisionTreeClassifier,
    func_name: str = "select_kernel",
    feature_names: tuple[str, ...] = FEATURE_NAMES,
) -> str:
    """Emit the tree as nested-if Python source (the launcher embedding).

    ``feature_names`` are the argument names of the generated selector —
    each kernel family passes its own (``repro.core.families``).
    """
    lines = [
        f"def {func_name}({', '.join(feature_names)}):",
        '    """Auto-generated kernel-selection decision tree."""',
    ]

    def rec(node: _Node, indent: int) -> None:
        pad = "    " * indent
        if node.left is None:
            lines.append(f"{pad}return {int(node.label)}")
            return
        lines.append(f"{pad}if {feature_names[node.feature]} <= {node.threshold!r}:")
        rec(node.left, indent + 1)
        lines.append(f"{pad}else:")
        rec(node.right, indent + 1)

    rec(tree.root_, 1)
    return "\n".join(lines) + "\n"
