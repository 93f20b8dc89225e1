"""Runtime kernel-selection classifiers (paper §5, Tables 1-2).

Maps problem-size features -> index of the deployed kernel config to launch.
All classifiers implement ``fit(x, y)`` / ``predict(x)`` and are numpy-only.

The classifier zoo mirrors the paper: three decision trees with increasing
regularization (A: unlimited; B: depth<=6, leaf>=3; C: depth<=3, leaf>=4),
k-nearest-neighbours (k = 1, 3, 7), linear and RBF SVMs (Pegasos-style SGD on
the hinge loss — primal for linear, kernelized dual for RBF), a random forest,
and a small MLP.

Copied from ``repro/core/classify.py`` (numpy only); each ``a @ b`` is
spelled ``np.matmul(a, b)``, the same operation, because the port keeps ``@``
to its plain tensor versions (``kernels/ref.py``).
"""
from __future__ import annotations

import numpy as np

from .flattree import FlatTree

__all__ = [
    "FlatTree",
    "DecisionTreeClassifier",
    "KNeighborsClassifier",
    "LinearSVM",
    "RadialSVM",
    "RandomForestClassifier",
    "MLPClassifier",
    "make_classifier",
    "fit_weighted",
    "CLASSIFIERS",
]


def fit_weighted(clf, x: np.ndarray, y: np.ndarray, sample_weight: np.ndarray | None = None):
    """Fit ``clf`` with per-sample traffic weights (the retune path).

    Decision trees take ``sample_weight`` natively; classifiers without the
    parameter get an equivalent dataset with rows replicated in proportion to
    weight (bounded at 4 copies of the heaviest row per original row, enough
    resolution for a traffic histogram without quadratic blow-up).
    """
    if sample_weight is None:
        return clf.fit(x, y)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=int)
    w = np.asarray(sample_weight, dtype=np.float64)
    if w.shape != (len(y),):
        raise ValueError(f"sample_weight shape {w.shape} != ({len(y)},)")
    try:
        return clf.fit(x, y, sample_weight=w)
    except TypeError:
        pass
    pos = w[w > 0]
    if pos.size == 0:
        return clf.fit(x, y)
    reps = np.clip(np.round(4.0 * w / pos.max()), 0, 4).astype(int)
    reps[w > 0] = np.maximum(reps[w > 0], 1)  # every observed row survives
    idx = np.repeat(np.arange(len(y)), reps)
    return clf.fit(x[idx], y[idx])


def _standardize_fit(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = x.mean(0)
    sd = x.std(0)
    sd = np.where(sd > 1e-12, sd, 1.0)
    return mu, sd


# ---------------------------------------------------------------------------
# Decision tree (CART, gini)
# ---------------------------------------------------------------------------
class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "label", "counts")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.label = 0
        self.counts = None


class DecisionTreeClassifier:
    def __init__(self, max_depth: int | None = None, min_samples_leaf: int = 1, seed: int = 0):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.root_: _Node | None = None
        self.flat_: FlatTree | None = None  # compiled after fit (fast path)
        self.n_classes_ = 0
        self.max_features: int | None = None  # set by RandomForest

    # -- training ---------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray, sample_weight: np.ndarray | None = None):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=int)
        self.n_classes_ = int(y.max()) + 1 if y.size else 1
        rng = np.random.default_rng(self.seed)
        w = np.ones(len(y)) if sample_weight is None else np.asarray(sample_weight, float)
        n = len(y)
        onehot = np.zeros((n, self.n_classes_))
        if n:
            onehot[np.arange(n), y] = w
        self.root_, self.flat_ = self._grow_levels(x, onehot, rng)
        return self

    def _gini(self, counts: np.ndarray) -> float:
        tot = counts.sum()
        if tot <= 0:
            return 0.0
        p = counts / tot
        return float(1.0 - (p**2).sum())

    def _grow_levels(self, x: np.ndarray, onehot: np.ndarray, rng) -> tuple[_Node, FlatTree]:
        """Level-synchronous CART growth — the vectorized training fast path.

        Features are sorted once; every deeper level re-groups the sorted row
        orders by node with a stable partition.  The split search for ALL
        nodes of a level runs as one segmented cumulative-class-count sweep:
        prefix sums (reset at node boundaries) give left/right Gini impurity
        at every candidate threshold of every node in closed form, so the
        Python/numpy call count scales with tree *depth*, not node count.
        The compiled :class:`FlatTree` is assembled in the same pass (BFS
        layout — children always follow parents, as ``validate`` requires).
        """
        n, nf = x.shape
        c = onehot.shape[1]
        ml = max(self.min_samples_leaf, 1)
        root = _Node()
        root.counts = onehot.sum(0)
        root.label = int(root.counts.argmax())
        # flat arrays, filled alongside the node graph (index 0 = root)
        f_feature = [-1]
        f_thr = [0.0]
        f_left = [-1]
        f_right = [-1]
        f_label = [root.label]
        f_counts = [root.counts]

        def finish() -> tuple[_Node, FlatTree]:
            flat = FlatTree(f_feature, f_thr, f_left, f_right, f_label,
                            self.n_classes_, np.stack(f_counts))
            return root, flat

        if n == 0:
            return finish()
        sub_features = self.max_features is not None and self.max_features < nf
        # Sort once per feature; stable partitions preserve this order below.
        order = np.argsort(x, axis=0, kind="stable")  # (n_rows, nf), row ids
        cols = np.arange(nf)[None, :]
        nodes = [root]  # active (still-splittable-candidate) nodes, in row order
        flat_idx = [0]  # flat-array index of each active node
        sizes = np.array([n])
        node_counts = root.counts[None, :]
        depth = 0
        while nodes:
            # -- per-node stopping rules (bulk, then a cheap python filter) --
            w_tot = node_counts.sum(1)
            can_split = ~(
                (node_counts.max(1) == w_tot)
                | (sizes < 2 * ml)
                | (np.zeros(len(nodes), bool) if self.max_depth is None else np.full(len(nodes), depth >= self.max_depth))
            )
            if not can_split.any():
                break
            if not can_split.all():
                row_keep = np.repeat(can_split, sizes)
                order = order[row_keep]
                nodes = [nd for nd, ok_ in zip(nodes, can_split) if ok_]
                flat_idx = [fi for fi, ok_ in zip(flat_idx, can_split) if ok_]
                node_counts = node_counts[can_split]
                sizes = sizes[can_split]
                w_tot = w_tot[can_split]
            k = len(nodes)
            na = order.shape[0]
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            seg_rep = np.repeat(np.arange(k), sizes)

            # -- segmented prefix class counts ------------------------------
            csum = np.cumsum(onehot[order], axis=0)  # (na, nf, c)
            base = csum[starts - 1]  # prefix just before each segment...
            base[0] = 0.0  # ...with segment 0's base (wrapped index) zeroed
            lc = csum - base[seg_rep]  # left counts at split index i = pos+1
            rc = np.repeat(node_counts, sizes, 0)[:, None, :] - lc
            nl = lc.sum(-1)  # (na, nf) left weight (per feature: weighted rows differ)
            nr = w_tot[seg_rep, None] - nl
            pos1 = np.arange(na) - starts[seg_rep] + 1  # split index within segment
            valid = (pos1 >= ml) & (pos1 <= np.repeat(sizes, sizes) - ml)
            xs = x[order, cols]  # (na, nf) presorted feature values
            xnext = np.empty_like(xs)
            xnext[:-1] = xs[1:]
            xnext[-1] = np.inf  # last row is never a valid split anyway
            ok = valid[:, None] & (xs != xnext) & (nl > 0) & (nr > 0)
            # Total node weight is constant across a segment's positions, so
            # minimizing weighted Gini (nl*gl + nr*gr)/W is maximizing
            # h = sum(lc^2)/nl + sum(rc^2)/nr.
            with np.errstate(divide="ignore", invalid="ignore"):
                h = (lc * lc).sum(-1) / nl + (rc * rc).sum(-1) / nr
            h[~ok] = -np.inf
            if sub_features:  # random forest: per-node feature subsets
                allow = np.zeros((k, nf), dtype=bool)
                for j in range(k):
                    allow[j, rng.choice(nf, size=self.max_features, replace=False)] = True
                h[~allow[seg_rep]] = -np.inf

            # -- best split per segment -------------------------------------
            hrow = h.max(1)
            frow = h.argmax(1)
            seg_max = np.maximum.reduceat(hrow, starts)
            hit = np.where(hrow == seg_max[seg_rep], np.arange(na), na)
            br = np.minimum(np.minimum.reduceat(hit, starts), na - 1)  # first best row
            parent_h = (node_counts * node_counts).sum(1) / w_tot
            do_split = np.isfinite(seg_max) & (seg_max > parent_h + 1e-12 * w_tot)
            if not do_split.any():
                break
            f_k = frow[br]
            thr = 0.5 * (xs[br, f_k] + xs[np.minimum(br + 1, na - 1), f_k])
            hi = xs[np.minimum(br + 1, na - 1), f_k]
            thr = np.where(thr < hi, thr, xs[br, f_k])  # fp midpoint collapse
            lcounts = lc[br, f_k]  # (k, c)
            rcounts = node_counts - lcounts
            nl_k = pos1[br]
            nr_k = sizes - nl_k

            # -- wire child nodes (python bookkeeping on bulk scalars) -------
            llab = lcounts.argmax(1).tolist()
            rlab = rcounts.argmax(1).tolist()
            f_l = f_k.tolist()
            thr_l = thr.tolist()
            split_l = do_split.tolist()
            new_nodes: list[_Node] = []
            new_flat_idx: list[int] = []
            for j, nd in enumerate(nodes):
                if not split_l[j]:
                    continue
                nd.feature, nd.threshold = int(f_l[j]), float(thr_l[j])
                left, right = _Node(), _Node()
                left.counts, left.label = lcounts[j], llab[j]
                right.counts, right.label = rcounts[j], rlab[j]
                nd.left, nd.right = left, right
                new_nodes.extend((left, right))
                # mirror into the flat arrays: leaves now, patched if split later
                fi = flat_idx[j]
                li = len(f_feature)
                f_feature[fi] = nd.feature
                f_thr[fi] = nd.threshold
                f_left[fi] = li
                f_right[fi] = li + 1
                f_feature.extend((-1, -1))
                f_thr.extend((0.0, 0.0))
                f_left.extend((-1, -1))
                f_right.extend((-1, -1))
                f_label.extend((left.label, right.label))
                f_counts.extend((left.counts, right.counts))
                new_flat_idx.extend((li, li + 1))

            # -- stable partition of every feature's order for the next level
            is_left = np.zeros(n, dtype=bool)
            ids0 = order[:, 0]
            split_rep = do_split[seg_rep]
            is_left[ids0] = (x[ids0, f_k[seg_rep]] <= thr[seg_rep]) & split_rep
            order = order[split_rep]
            seg_next = seg_rep[split_rep]
            for f in range(nf):
                cid = order[:, f]
                key = 2 * seg_next + (~is_left[cid])
                order[:, f] = cid[np.argsort(key, kind="stable")]
            nodes = new_nodes
            flat_idx = new_flat_idx
            sizes = np.stack([nl_k[do_split], nr_k[do_split]], 1).ravel()
            node_counts = np.stack([lcounts[do_split], rcounts[do_split]], 1).reshape(-1, c)
            depth += 1
        return finish()

    # -- inference --------------------------------------------------------
    def _ensure_flat(self) -> FlatTree:
        if self.flat_ is None:
            self.flat_ = FlatTree.from_node(self.root_, self.n_classes_)
        return self.flat_

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized batch predict via the compiled :class:`FlatTree`."""
        x = np.asarray(x, dtype=np.float64)
        return self._ensure_flat().predict(x)

    def predict_nested(self, x: np.ndarray) -> np.ndarray:
        """Reference per-row nested walk (equivalence oracle for the flat path)."""
        x = np.asarray(x, dtype=np.float64)
        out = np.empty(len(x), dtype=int)
        for i, row in enumerate(x):
            node = self.root_
            while node.left is not None:
                node = node.left if row[node.feature] <= node.threshold else node.right
            out[i] = node.label
        return out

    def predict_counts(self, x: np.ndarray) -> np.ndarray:
        """Per-sample class-count vectors at the reached leaf (for forests)."""
        x = np.asarray(x, dtype=np.float64)
        flat = self._ensure_flat()
        if flat.counts is not None:
            c = flat.predict_counts(x)
            if c.shape[1] == self.n_classes_:
                return c
            # forest bootstrap samples can miss the top classes: pad out
            out = np.zeros((len(x), self.n_classes_))
            out[:, : c.shape[1]] = c
            return out
        out = np.zeros((len(x), self.n_classes_))
        for i, row in enumerate(x):
            node = self.root_
            while node.left is not None:
                node = node.left if row[node.feature] <= node.threshold else node.right
            c = node.counts
            out[i, : len(c)] = c / max(c.sum(), 1e-12)
        return out

    # -- depth / size introspection (for codegen & tests) ------------------
    def depth(self) -> int:
        def d(n):
            return 0 if n is None or n.left is None else 1 + max(d(n.left), d(n.right))

        return d(self.root_)

    def n_leaves(self) -> int:
        def c(n):
            return 1 if n.left is None else c(n.left) + c(n.right)

        return c(self.root_)


# ---------------------------------------------------------------------------
# k nearest neighbours
# ---------------------------------------------------------------------------
class KNeighborsClassifier:
    def __init__(self, k: int = 3):
        self.k = k

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        self._mu, self._sd = _standardize_fit(x)
        self._x = (x - self._mu) / self._sd
        self._y = np.asarray(y, dtype=int)
        self.n_classes_ = int(self._y.max()) + 1 if self._y.size else 1
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = (np.asarray(x, dtype=np.float64) - self._mu) / self._sd
        d2 = ((x[:, None, :] - self._x[None, :, :]) ** 2).sum(-1)
        k = min(self.k, len(self._y))
        nn = np.argpartition(d2, k - 1, axis=1)[:, :k]
        out = np.empty(len(x), dtype=int)
        for i in range(len(x)):
            out[i] = np.bincount(self._y[nn[i]], minlength=self.n_classes_).argmax()
        return out


# ---------------------------------------------------------------------------
# SVMs (Pegasos SGD on hinge loss, one-vs-rest)
# ---------------------------------------------------------------------------
class LinearSVM:
    def __init__(self, lam: float = 1e-3, epochs: int = 60, seed: int = 0):
        self.lam, self.epochs, self.seed = lam, epochs, seed

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=int)
        self._mu, self._sd = _standardize_fit(x)
        xs = (x - self._mu) / self._sd
        xs = np.hstack([xs, np.ones((len(xs), 1))])  # bias feature
        self.n_classes_ = int(y.max()) + 1
        n, d = xs.shape
        rng = np.random.default_rng(self.seed)
        self._w = np.zeros((self.n_classes_, d))
        for c in range(self.n_classes_):
            t = 0
            yc = np.where(y == c, 1.0, -1.0)
            w = np.zeros(d)
            for _ in range(self.epochs):
                for i in rng.permutation(n):
                    t += 1
                    eta = 1.0 / (self.lam * t)
                    margin = yc[i] * np.matmul(w, xs[i])
                    w *= 1 - eta * self.lam
                    if margin < 1:
                        w += eta * yc[i] * xs[i]
            self._w[c] = w
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        xs = (np.asarray(x, dtype=np.float64) - self._mu) / self._sd
        xs = np.hstack([xs, np.ones((len(xs), 1))])
        return np.matmul(xs, self._w.T).argmax(1)


class RadialSVM:
    """Kernelized Pegasos (RBF) one-vs-rest SVM."""

    def __init__(self, lam: float = 1e-2, epochs: int = 40, gamma: float | None = None, seed: int = 0):
        self.lam, self.epochs, self.gamma, self.seed = lam, epochs, gamma, seed

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-self._g * d2)

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=int)
        self._mu, self._sd = _standardize_fit(x)
        self._x = (x - self._mu) / self._sd
        n = len(y)
        if self.gamma is None:
            d2 = ((self._x[:, None, :] - self._x[None, :, :]) ** 2).sum(-1)
            nz = d2[d2 > 0]
            self._g = 1.0 / max(np.median(nz), 1e-12) if nz.size else 1.0
        else:
            self._g = self.gamma
        gram = self._kernel(self._x, self._x)
        self.n_classes_ = int(y.max()) + 1
        self._alpha = np.zeros((self.n_classes_, n))
        rng = np.random.default_rng(self.seed)
        for c in range(self.n_classes_):
            yc = np.where(y == c, 1.0, -1.0)
            a = np.zeros(n)
            t = 0
            for _ in range(self.epochs):
                for i in rng.permutation(n):
                    t += 1
                    f = np.matmul(a * yc, gram[:, i]) / (self.lam * t)
                    if yc[i] * f < 1:
                        a[i] += 1
            self._alpha[c] = a * yc / (self.lam * max(t, 1))
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        xs = (np.asarray(x, dtype=np.float64) - self._mu) / self._sd
        k = self._kernel(xs, self._x)
        return np.matmul(k, self._alpha.T).argmax(1)


# ---------------------------------------------------------------------------
# Random forest
# ---------------------------------------------------------------------------
class RandomForestClassifier:
    def __init__(self, n_trees: int = 30, max_depth: int | None = None, seed: int = 0):
        self.n_trees, self.max_depth, self.seed = n_trees, max_depth, seed
        self.trees_: list[DecisionTreeClassifier] = []

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=int)
        rng = np.random.default_rng(self.seed)
        n, nf = x.shape
        self.n_classes_ = int(y.max()) + 1
        self.trees_ = []
        mf = max(1, int(np.sqrt(nf)))
        for t in range(self.n_trees):
            idx = rng.integers(0, n, size=n)  # bootstrap
            tree = DecisionTreeClassifier(max_depth=self.max_depth, seed=self.seed + t)
            tree.max_features = mf
            tree.n_classes_ = self.n_classes_
            tree.fit(x[idx], y[idx])
            tree.n_classes_ = self.n_classes_
            self.trees_.append(tree)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        votes = np.zeros((len(x), self.n_classes_))
        for tree in self.trees_:
            pc = tree.predict_counts(x)
            votes[:, : pc.shape[1]] += pc
        return votes.argmax(1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLPClassifier:
    def __init__(self, hidden: int = 32, epochs: int = 400, lr: float = 1e-2, seed: int = 0):
        self.hidden, self.epochs, self.lr, self.seed = hidden, epochs, lr, seed

    def fit(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=int)
        self._mu, self._sd = _standardize_fit(x)
        xs = (x - self._mu) / self._sd
        n, d = xs.shape
        c = int(y.max()) + 1
        self.n_classes_ = c
        rng = np.random.default_rng(self.seed)
        w1 = rng.normal(0, np.sqrt(2.0 / d), (d, self.hidden))
        b1 = np.zeros(self.hidden)
        w2 = rng.normal(0, np.sqrt(2.0 / self.hidden), (self.hidden, c))
        b2 = np.zeros(c)
        onehot = np.zeros((n, c))
        onehot[np.arange(n), y] = 1.0
        # Adam
        ms = [np.zeros_like(p) for p in (w1, b1, w2, b2)]
        vs = [np.zeros_like(p) for p in (w1, b1, w2, b2)]
        params = [w1, b1, w2, b2]
        for t in range(1, self.epochs + 1):
            h = np.maximum(np.matmul(xs, params[0]) + params[1], 0.0)
            logits = np.matmul(h, params[2]) + params[3]
            logits -= logits.max(1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(1, keepdims=True)
            g_logits = (p - onehot) / n
            gw2 = np.matmul(h.T, g_logits)
            gb2 = g_logits.sum(0)
            gh = np.matmul(g_logits, params[2].T)
            gh[h <= 0] = 0.0
            gw1 = np.matmul(xs.T, gh)
            gb1 = gh.sum(0)
            grads = [gw1, gb1, gw2, gb2]
            b1m, b2m = 0.9, 0.999
            for j, g in enumerate(grads):
                ms[j] = b1m * ms[j] + (1 - b1m) * g
                vs[j] = b2m * vs[j] + (1 - b2m) * g * g
                mh = ms[j] / (1 - b1m**t)
                vh = vs[j] / (1 - b2m**t)
                params[j] -= self.lr * mh / (np.sqrt(vh) + 1e-8)
        self._params = params
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        xs = (np.asarray(x, dtype=np.float64) - self._mu) / self._sd
        w1, b1, w2, b2 = self._params
        h = np.maximum(np.matmul(xs, w1) + b1, 0.0)
        return (np.matmul(h, w2) + b2).argmax(1)


# ---------------------------------------------------------------------------
# registry (paper Tables 1-2 rows)
# ---------------------------------------------------------------------------
CLASSIFIERS: dict[str, callable] = {
    "DecisionTreeA": lambda seed=0: DecisionTreeClassifier(max_depth=None, min_samples_leaf=1, seed=seed),
    "DecisionTreeB": lambda seed=0: DecisionTreeClassifier(max_depth=6, min_samples_leaf=3, seed=seed),
    "DecisionTreeC": lambda seed=0: DecisionTreeClassifier(max_depth=3, min_samples_leaf=4, seed=seed),
    "1NearestNeighbor": lambda seed=0: KNeighborsClassifier(k=1),
    "3NearestNeighbor": lambda seed=0: KNeighborsClassifier(k=3),
    "7NearestNeighbor": lambda seed=0: KNeighborsClassifier(k=7),
    "LinearSVM": lambda seed=0: LinearSVM(seed=seed),
    "RadialSVM": lambda seed=0: RadialSVM(seed=seed),
    "RandomForest": lambda seed=0: RandomForestClassifier(n_trees=30, seed=seed),
    "MLP": lambda seed=0: MLPClassifier(seed=seed),
}


def make_classifier(name: str, seed: int = 0):
    """A fresh classifier by registry name, seeded for reproducible fits.

    ``seed`` reaches every stochastic classifier's RNG (tie-breaking,
    SGD shuffling, forest bagging); the k-NN family has no randomness and
    ignores it.  Threading the tune seed here is what makes
    ``tune_for_archs``/``tune_fleet`` bit-reproducible run-to-run.
    """
    try:
        return CLASSIFIERS[name](seed=seed)
    except KeyError:
        raise ValueError(f"unknown classifier {name!r}; expected one of {sorted(CLASSIFIERS)}") from None
