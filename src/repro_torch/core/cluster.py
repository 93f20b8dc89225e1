"""Unsupervised kernel-subset selection (paper §4).

Each problem instance (a set of matrix sizes) is a point in R^{n_configs}
whose coordinates are its normalized per-config performance.  Clustering
groups problems with similar performance characteristics; one kernel config
is then extracted per cluster (paper §4.2):

  * methods with centroids (k-means family) pick the argmax config of the
    centroid;
  * methods yielding only labels (spectral, density, tree leaves) pick the
    argmax config of the *geometric mean* of the cluster members.

Implemented selectors (paper §4.1):
  ``topn``          — Top-N by best-count baseline.
  ``kmeans``        — k-means++ / Lloyd.
  ``pca_kmeans``    — PCA dimensionality reduction, then k-means.
  ``spectral``      — RBF similarity graph, normalized Laplacian eigenmaps,
                      then k-means (classic spectral clustering).
  ``density``       — HDBSCAN-style density clustering: mutual-reachability
                      MST, cut hierarchically; hyperparameters swept until the
                      requested number of clusters is produced (paper §4.1.4).
  ``tree``          — multi-output regression tree (sizes -> perf vector) with
                      the leaf count capped at n_kernels; each leaf's mean
                      perf vector is a cluster representative (paper §4.1.5).

Everything is numpy-only (no sklearn available in this environment).

Copied verbatim from ``repro/core/cluster.py`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from .pca import PCA

CLUSTER_METHODS = ("topn", "kmeans", "pca_kmeans", "spectral", "density", "tree")

_EPS = 1e-12


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rng.integers(n)]
    d2 = np.sum((x - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), _EPS)
        centers[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((x - centers[i]) ** 2, axis=1))
    return centers


def kmeans(
    x: np.ndarray,
    k: int,
    *,
    n_init: int = 8,
    max_iter: int = 200,
    seed: int = 0,
    init_centers: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm with k-means++ init. Returns (labels, centers).

    ``init_centers`` warm-starts Lloyd from caller-supplied centroids (the
    incremental-retune path seeds with the deployed clustering so refinement
    converges in a handful of iterations instead of ``n_init`` cold restarts).
    Fewer than ``k`` rows are topped up by k-means++; extra rows are ignored.
    """
    x = np.asarray(x, dtype=np.float64)
    k = min(k, x.shape[0])
    rng = np.random.default_rng(seed)
    warm = None
    if init_centers is not None:
        warm = np.asarray(init_centers, dtype=np.float64)[:k]
        if warm.shape[0] < k:
            # top up missing centroids with k-means++ picks over the data
            extra = _kmeans_pp_init(x, k - warm.shape[0], rng)
            warm = np.vstack([warm, extra])
        n_init = 1
    best = (None, None, np.inf)
    for _ in range(n_init):
        centers = warm if warm is not None else _kmeans_pp_init(x, k, rng)
        for _ in range(max_iter):
            d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            labels = d2.argmin(1)
            new = np.stack(
                [x[labels == j].mean(0) if np.any(labels == j) else centers[j] for j in range(k)]
            )
            if np.allclose(new, centers):
                centers = new
                break
            centers = new
        inertia = ((x - centers[labels]) ** 2).sum()
        if inertia < best[2]:
            best = (labels, centers, inertia)
    return best[0], best[1]


# ---------------------------------------------------------------------------
# spectral clustering
# ---------------------------------------------------------------------------
def spectral_labels(x: np.ndarray, k: int, *, seed: int = 0) -> np.ndarray:
    """RBF-affinity normalized-Laplacian spectral clustering."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    k = min(k, n)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    # Median-heuristic bandwidth over nonzero distances.
    nz = d2[d2 > 0]
    gamma = 1.0 / max(np.median(nz), _EPS) if nz.size else 1.0
    a = np.exp(-gamma * d2)
    np.fill_diagonal(a, 0.0)
    deg = a.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, _EPS))
    lap = np.eye(n) - dinv[:, None] * a * dinv[None, :]
    # k smallest eigenvectors of the symmetric normalized Laplacian.
    vals, vecs = np.linalg.eigh(lap)
    emb = vecs[:, :k]
    # Row-normalize (Ng-Jordan-Weiss).
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.maximum(norms, _EPS)
    labels, _ = kmeans(emb, k, seed=seed)
    return labels


# ---------------------------------------------------------------------------
# density clustering (HDBSCAN-style)
# ---------------------------------------------------------------------------
def _mst_edges(dist: np.ndarray) -> list[tuple[float, int, int]]:
    """Prim's MST over a dense distance matrix -> sorted edge list."""
    n = dist.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    in_tree[0] = True
    best = dist[0].copy()
    parent = np.zeros(n, dtype=int)
    edges: list[tuple[float, int, int]] = []
    for _ in range(n - 1):
        cand = np.where(in_tree, np.inf, best)
        j = int(cand.argmin())
        edges.append((float(best[j]), int(parent[j]), j))
        in_tree[j] = True
        upd = dist[j] < best
        best = np.where(upd, dist[j], best)
        parent = np.where(upd, j, parent)
    edges.sort()
    return edges


def density_labels(
    x: np.ndarray,
    k: int,
    *,
    min_cluster_size_range: tuple[int, ...] = (2, 3, 4, 5, 8),
    min_samples_range: tuple[int, ...] = (1, 2, 3, 5),
) -> np.ndarray:
    """HDBSCAN-flavoured density clustering with a hyperparameter sweep.

    Builds the mutual-reachability MST, then removes the largest edges one at
    a time; components smaller than ``min_cluster_size`` count as noise.  As
    HDBSCAN cannot be told how many clusters to produce, we sweep its
    hyperparameters and keep whichever yields exactly ``k`` clusters (paper
    §4.1.4); nearest match wins otherwise.  Noise points are assigned to the
    nearest cluster so every problem gets a label.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    d = np.sqrt(np.maximum(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1), 0.0))

    best_labels, best_err = None, np.inf
    for ms in min_samples_range:
        core = np.sort(d, axis=1)[:, min(ms, n - 1)]  # distance to ms-th neighbour
        mreach = np.maximum(np.maximum(core[:, None], core[None, :]), d)
        edges = _mst_edges(mreach)
        for mcs in min_cluster_size_range:
            labels = _cut_mst(edges, n, k, mcs)
            ncl = labels.max() + 1
            err = abs(ncl - k)
            if err < best_err:
                best_labels, best_err = labels, err
            if best_err == 0:
                break
        if best_err == 0:
            break

    labels = best_labels
    # Assign noise (-1) to nearest labelled point.
    noise = np.where(labels < 0)[0]
    ok = np.where(labels >= 0)[0]
    if ok.size == 0:
        return np.zeros(n, dtype=int)
    for i in noise:
        labels[i] = labels[ok[d[i, ok].argmin()]]
    # Compact label ids.
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def _cut_mst(edges: list[tuple[float, int, int]], n: int, k: int, min_cluster_size: int) -> np.ndarray:
    """Remove heaviest MST edges until ~k components of size>=min_cluster_size."""
    # Union-find over edges sorted ascending, stopping before the heaviest
    # (k-1) merges would have happened — equivalently, build with all but the
    # largest edges removed, trying successively smaller cut thresholds.
    for n_cut in range(k - 1, n):
        keep = edges[: max(len(edges) - n_cut, 0)]
        parent = list(range(n))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for _, u, v in keep:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
        roots = np.array([find(i) for i in range(n)])
        uniq, counts = np.unique(roots, return_counts=True)
        big = uniq[counts >= min_cluster_size]
        if len(big) >= k or n_cut == n - 1:
            labels = np.full(n, -1, dtype=int)
            for ci, r in enumerate(big):
                labels[roots == r] = ci
            return labels
    return np.zeros(n, dtype=int)


# ---------------------------------------------------------------------------
# regression-tree "clustering" (paper §4.1.5)
# ---------------------------------------------------------------------------
class _TreeNode:
    __slots__ = ("feature", "threshold", "left", "right", "value", "indices")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = None
        self.indices = None


def _best_split(x: np.ndarray, y: np.ndarray, min_leaf: int) -> tuple[int, float, float] | None:
    """Best (feature, threshold) minimizing summed variance of y halves.

    One vectorized sum-of-squared-error sweep per feature: prefix sums of y
    and y^2 give both halves' SSE at every candidate split position at once.
    """
    n, nf = x.shape
    best = None
    base = ((y - y.mean(0)) ** 2).sum()
    pos = np.arange(min_leaf, n - min_leaf + 1)
    pos = pos[(pos >= 1) & (pos <= n - 1)]
    if pos.size == 0:
        return None
    for f in range(nf):
        order = np.argsort(x[:, f], kind="stable")
        xs, ys = x[order, f], y[order]
        csum = np.cumsum(ys, axis=0)
        csum2 = np.cumsum(ys**2, axis=0)
        tot, tot2 = csum[-1], csum2[-1]
        valid = xs[pos - 1] != xs[pos]
        if not valid.any():
            continue
        nl = pos.astype(np.float64)
        nr = (n - pos).astype(np.float64)
        sl, sl2 = csum[pos - 1], csum2[pos - 1]
        sr, sr2 = tot[None, :] - sl, tot2[None, :] - sl2
        sse = (sl2 - sl**2 / nl[:, None]).sum(1) + (sr2 - sr**2 / nr[:, None]).sum(1)
        gain = np.where(valid, base - sse, -np.inf)
        j = int(gain.argmax())
        if best is None or gain[j] > best[2]:
            i = int(pos[j])
            thr = 0.5 * (xs[i - 1] + xs[i])
            best = (f, float(thr), float(gain[j]))
    if best is None or best[2] <= 1e-12:
        return None
    return best


def regression_tree_leaves(
    features: np.ndarray, perf: np.ndarray, max_leaves: int, *, min_leaf: int = 1
) -> np.ndarray:
    """Grow a multi-output regression tree best-first until ``max_leaves``.

    Returns integer leaf labels per problem — the tree-based "clustering" of
    paper §4.1.5 (splits on *matrix sizes*, values are performance vectors).
    """
    features = np.asarray(features, dtype=np.float64)
    perf = np.asarray(perf, dtype=np.float64)
    n = features.shape[0]
    root_idx = np.arange(n)
    # Best-first growth: priority queue on variance-reduction gain.
    leaves: list[np.ndarray] = [root_idx]
    splits: list[tuple[float, int, int, float, np.ndarray, np.ndarray]] = []

    def try_split(leaf_id: int) -> None:
        idx = leaves[leaf_id]
        if len(idx) < 2 * min_leaf:
            return
        got = _best_split(features[idx], perf[idx], min_leaf)
        if got is None:
            return
        f, thr, gain = got
        mask = features[idx, f] <= thr
        splits.append((gain, leaf_id, f, thr, idx[mask], idx[~mask]))

    try_split(0)
    while len(leaves) < max_leaves and splits:
        splits.sort(key=lambda s: -s[0])
        gain, leaf_id, f, thr, li, ri = splits.pop(0)
        if leaves[leaf_id] is None or len(leaves[leaf_id]) != len(li) + len(ri):
            continue  # stale entry
        leaves[leaf_id] = li
        leaves.append(ri)
        # Invalidate stale queued splits of this leaf.
        splits[:] = [s for s in splits if s[1] != leaf_id]
        try_split(leaf_id)
        try_split(len(leaves) - 1)

    labels = np.zeros(n, dtype=int)
    for ci, idx in enumerate(leaves):
        labels[idx] = ci
    return labels


# ---------------------------------------------------------------------------
# selection front-end (paper §4.2)
# ---------------------------------------------------------------------------
def _geomean(y: np.ndarray, axis: int = 0) -> np.ndarray:
    return np.exp(np.mean(np.log(np.maximum(y, _EPS)), axis=axis))


def _configs_from_labels(perf: np.ndarray, labels: np.ndarray, k: int) -> list[int]:
    chosen: list[int] = []
    for c in range(labels.max() + 1):
        members = perf[labels == c]
        if members.size == 0:
            continue
        gm = _geomean(members, axis=0)
        order = np.argsort(-gm)
        for cfg in order:
            if int(cfg) not in chosen:
                chosen.append(int(cfg))
                break
    return chosen[:k]


def _configs_from_centers(perf: np.ndarray, labels: np.ndarray, centers: np.ndarray, k: int) -> list[int]:
    chosen: list[int] = []
    for c in range(centers.shape[0]):
        order = np.argsort(-centers[c])
        for cfg in order:
            if int(cfg) not in chosen:
                chosen.append(int(cfg))
                break
    return chosen[:k]


def _pad_selection(chosen: list[int], perf: np.ndarray, k: int) -> list[int]:
    """If dedup left fewer than k configs, pad with global best-by-count."""
    if len(chosen) >= k:
        return chosen[:k]
    counts = np.bincount(perf.argmax(1), minlength=perf.shape[1])
    for cfg in np.argsort(-counts):
        if int(cfg) not in chosen:
            chosen.append(int(cfg))
        if len(chosen) == k:
            break
    return chosen


def select_configs(
    perf: np.ndarray,
    k: int,
    method: str = "pca_kmeans",
    *,
    features: np.ndarray | None = None,
    seed: int = 0,
    pca_components: int = 8,
    init_centers: np.ndarray | None = None,
) -> list[int]:
    """Select ``k`` kernel-config indices to deploy, from normalized perf data.

    ``perf`` is (n_problems, n_configs) *normalized* performance; ``features``
    (problem sizes) is required only by the ``tree`` method.  ``init_centers``
    (perf-space centroids) warm-starts the ``kmeans`` and ``pca_kmeans``
    methods — the incremental-retune and transfer-tuning paths; for
    ``pca_kmeans`` the centroids are projected through the fitted PCA so the
    warm start happens in the same reduced space the clustering runs in.
    Other methods ignore it.
    """
    perf = np.asarray(perf, dtype=np.float64)
    if method == "topn":
        counts = np.bincount(perf.argmax(1), minlength=perf.shape[1])
        return [int(i) for i in np.argsort(-counts)[:k]]
    if method == "kmeans":
        labels, centers = kmeans(perf, k, seed=seed, init_centers=init_centers)
        chosen = _configs_from_centers(perf, labels, centers, k)
    elif method == "pca_kmeans":
        pca = PCA(n_components=min(pca_components, perf.shape[1], perf.shape[0])).fit(perf)
        z = pca.transform(perf)
        warm = pca.transform(init_centers) if init_centers is not None else None
        labels, _ = kmeans(z, k, seed=seed, init_centers=warm)
        chosen = _configs_from_labels(perf, labels, k)
    elif method == "spectral":
        labels = spectral_labels(perf, k, seed=seed)
        chosen = _configs_from_labels(perf, labels, k)
    elif method == "density":
        labels = density_labels(perf, k)
        chosen = _configs_from_labels(perf, labels, k)
    elif method == "tree":
        if features is None:
            raise ValueError("tree selection requires problem-size features")
        labels = regression_tree_leaves(features, perf, k)
        chosen = _configs_from_labels(perf, labels, k)
    else:
        raise ValueError(f"unknown selection method {method!r}; expected one of {CLUSTER_METHODS}")
    return _pad_selection(chosen, perf, k)
