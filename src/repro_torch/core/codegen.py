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

Copied from ``repro/core/codegen.py``, ``bundle_to_python`` (the
multi-device launcher) included: it emits the reference's source for the
same bundle.
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


def bundle_to_python(bundle, func_name: str = "select_kernel") -> str:
    """Emit a whole :class:`DeploymentBundle` as standalone launcher source.

    One nested-if selector per (kernel family, device) —
    ``select_kernel_tpu_v5e`` for matmul (name kept for compat),
    ``select_attention_tpu_v5e`` / ``select_wkv_...`` / ... for every other
    family with a shipped tree — plus routing tables: ``DEVICE_SELECTORS``
    (matmul, keyed by canonical device name), ``FAMILY_SELECTORS`` (family ->
    device -> selector), a ``FALLBACKS`` copy of the nearest-device chains, a
    dispatching ``select_kernel`` and family-generic ``select_kernel_family``
    that route by device with the same fallback-order semantics as
    ``core.devices.resolve_device`` — the multi-target analogue of the
    paper's launcher embedding, with no imports of the package at use time.
    """
    import re

    from .devices import FALLBACKS
    from .families import get_family

    sections: list[str] = []
    names: dict[str, str] = {}
    family_names_tbl: dict[str, dict[str, str]] = {}
    for device in sorted(bundle.deployments):
        dep = bundle.deployments[device]
        slug = re.sub(r"[^0-9a-zA-Z_]", "_", device)
        fn = f"{func_name}_{slug}"
        names[device] = fn
        family_names_tbl.setdefault("matmul", {})[device] = fn
        sections.append(tree_to_python(dep.classifier, fn))
        for fam_name in dep.family_names():
            if fam_name == "matmul":
                continue
            configs, tree = dep.family_tuning(fam_name)
            if not isinstance(tree, DecisionTreeClassifier):
                continue  # untuned / non-tree family: nothing to embed
            fam = get_family(fam_name)
            ffn = f"select_{re.sub(r'[^0-9a-zA-Z_]', '_', fam_name)}_{slug}"
            family_names_tbl.setdefault(fam_name, {})[device] = ffn
            sections.append(tree_to_python(tree, ffn, feature_names=fam.feature_names))
    table = ",\n".join(f"    {d!r}: {fn}" for d, fn in sorted(names.items()))
    fam_table = ",\n".join(
        "    {!r}: {{{}}}".format(
            fam, ", ".join(f"{d!r}: {fn}" for d, fn in sorted(devs.items()))
        )
        for fam, devs in sorted(family_names_tbl.items())
    )
    chains = ",\n".join(
        f"    {d!r}: {tuple(c for c in chain if c in names)!r}"
        for d, chain in sorted(FALLBACKS.items())
    )
    args = ", ".join(FEATURE_NAMES)
    sections.append(
        "\n".join(
            [
                "import re as _re",
                "",
                "DEVICE_SELECTORS = {",
                table,
                "}",
                "",
                "FAMILY_SELECTORS = {",
                fam_table,
                "}",
                "",
                "FALLBACKS = {",
                chains,
                "}",
                "",
                "def _canon_device(device):",
                '    """Normalize a raw device_kind string to the canonical slug keys above."""',
                "    low = str(device).strip().lower()",
                "    if low in ('cpu', 'host_cpu'):",
                "        return 'host_cpu'",
                r"    m = _re.search(r'tpu[\s_-]*v(\d+)[\s_-]*(lite|e|p|i)?', low)",
                "    if m:",
                "        variant = {'lite': 'e', 'i': ''}.get(m.group(2) or '', m.group(2) or '')",
                "        return 'tpu_v' + m.group(1) + variant",
                r"    return _re.sub(r'[^a-z0-9]+', '_', low).strip('_') or 'unknown'",
                "",
                "def _resolve(table, device):",
                '    """Nearest-sibling device resolution over one selector table."""',
                "    device = _canon_device(device)",
                "    fn = table.get(device)",
                "    if fn is None:",
                "        for cand in FALLBACKS.get(device, ()):",
                "            if cand in table:",
                "                fn = table[cand]",
                "                break",
                "    if fn is None:",
                "        fam = device.split('_', 1)[0]",
                "        for cand in sorted(table):",
                "            if cand.split('_', 1)[0] == fam:",
                "                fn = table[cand]",
                "                break",
                "    if fn is None:",
                "        fn = table[sorted(table)[0]]",
                "    return fn",
                "",
                f"def {func_name}(device, {args}):",
                '    """Route to the deployed matmul selector for this device."""',
                f"    return _resolve(DEVICE_SELECTORS, device)({args})",
                "",
                f"def {func_name}_family(family, device, *features):",
                '    """Route any kernel family (matmul, attention, wkv, ssm_scan, ...).',
                "",
                "    ``features`` are the family's own featurization, in its declared",
                "    order; raises KeyError for a family this bundle does not ship.",
                '    """',
                "    table = FAMILY_SELECTORS[family]",
                "    return _resolve(table, device)(*features)",
            ]
        )
    )
    return "\n\n".join(sections) + "\n"


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
