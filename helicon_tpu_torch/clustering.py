"""Clustering without scikit-learn: agglomerative clustering with a minimum
cluster size, k-means and the silhouette score.

The reference (``helicon_tpu/clustering.py`` and
``helicon_tpu/io/metadata.assign_beamshifts_to_cluster``) calls
scikit-learn's ``AgglomerativeClustering``, ``KMeans`` and
``silhouette_score``; the card's machine has no scikit-learn, so this
module reproduces them label for label:

- the agglomerative tree is built on the host with scipy, as
  scikit-learn builds it without a connectivity graph (``ward`` by
  ``scipy.cluster.hierarchy.ward``, ``average`` / ``complete`` by
  ``hierarchy.linkage``, ``single`` by scikit-learn's own minimum spanning
  tree, copied here), and cut in ``_hc_cut``'s heap order, which decides
  the label numbers; with a connectivity graph, scikit-learn's structured
  trees (``ward_tree``, ``linkage_tree``: heap merges over the graph in
  its order, the graph's components joined by their nearest pairs, the
  early stop under n_clusters) are ported to the host with numpy, scipy
  and ``heapq``;
- the reassignment of undersized clusters, the nearest pairs that join a
  graph's components, Lloyd's iterations and the silhouette's pair
  distances run on ``device`` in float64, with
  scikit-learn's distance formula ||x||^2 - 2 x.y + ||y||^2;
- k-means++ draws its seeds from ``numpy.random.RandomState`` in
  scikit-learn's order, so a seed gives scikit-learn's clustering.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

__all__ = ["AgglomerativeClusteringWithMinSize", "kmeans", "silhouette_score"]

# pair distances held at once on the CPU; on the card a quarter of the free
# memory, at most CUDA_CHUNK_BYTES
CPU_CHUNK_BYTES = 64 << 20
CUDA_CHUNK_BYTES = 2 << 30

# scikit-learn's KMeans defaults (max_iter, tol) and the seed both callers
# of the reference pass (random_state=0)
KMEANS_MAX_ITER = 300
KMEANS_TOL = 1e-4
KMEANS_SEED = 0


def _row_chunk(n_cols: int, device) -> int:
    """Rows of an (r, n_cols) float64 table, two copies of it live at
    once, that fit the pass budget."""
    device = torch.device(device)
    budget = CPU_CHUNK_BYTES
    if device.type == "cuda":
        budget = min(torch.cuda.mem_get_info(device)[0] // 4, CUDA_CHUNK_BYTES)
    return max(1, int(budget // (8 * 2 * max(n_cols, 1))))


def _sq_distances(a, b, a_sq, b_sq):
    """scikit-learn's squared Euclidean distances (``_euclidean_distances``,
    float64): -2 a.b^T + ||a||^2 + ||b||^2, clipped at 0."""
    d = -2 * (a @ b.T)
    d += a_sq[:, None]
    d += b_sq[None, :]
    return d.clamp_(min=0)


# ---------------------------------------------------------------------------
# the agglomerative tree (host, scipy), as sklearn/cluster/_agglomerative.py
# ---------------------------------------------------------------------------

_SCIPY_METRIC = {"l2": "euclidean", "l1": "cityblock", "manhattan": "cityblock"}
_MST_METRICS = {"euclidean", "l2", "manhattan", "cityblock", "l1"}


def _mst_linkage_core(X: np.ndarray, metric: str) -> np.ndarray:
    """scikit-learn's MST-LINKAGE-CORE (``_hierarchical_fast.mst_linkage_core``):
    Prim's tree from sample 0, each distance evaluated feature by feature."""
    n = len(X)
    in_tree = np.zeros(n, bool)
    current = np.full(n, np.inf)
    result = np.zeros((n - 1, 3))
    node = 0
    manhattan = _SCIPY_METRIC.get(metric, metric) == "cityblock"
    for i in range(n - 1):
        in_tree[node] = True
        d = np.zeros(n)
        for k in range(X.shape[1]):
            t = X[:, k] - X[node, k]
            d += np.abs(t) if manhattan else t * t
        if not manhattan:
            d = np.sqrt(d)
        current = np.where(~in_tree & (d < current), d, current)
        cand = np.where(in_tree, np.inf, current)
        new = int(np.argmin(cand)) if np.isfinite(cand).any() else 0
        result[i] = (node, new, cand[new])
        node = new
    return result


def _single_linkage_label(L: np.ndarray) -> np.ndarray:
    """scikit-learn's ``_single_linkage_label``: an MST sorted by weight as a
    scipy linkage, merged with its union-find."""
    n = L.shape[0] + 1
    parent = np.full(2 * n - 1, -1, np.intp)
    size = np.concatenate([np.ones(n, np.intp), np.zeros(n - 1, np.intp)])
    next_label = n
    out = np.zeros((L.shape[0], 4))

    def find(x):
        p = x
        while parent[x] != -1:
            x = parent[x]
        while parent[p] != x and p != x:
            parent[p], p = x, parent[p]
        return x

    for i, (left, right, delta) in enumerate(L):
        a, b = find(int(left)), find(int(right))
        out[i] = (a, b, delta, size[a] + size[b])
        parent[a] = parent[b] = next_label
        size[next_label] = size[a] + size[b]
        next_label += 1
    return out


def _linkage_tree(X: np.ndarray, linkage: str, metric: str):
    """(children, distances) of the full tree, as ``ward_tree`` /
    ``linkage_tree`` build it without a connectivity graph."""
    from scipy.cluster import hierarchy

    if linkage == "ward":
        out = hierarchy.ward(np.require(X, requirements="W"))
    else:
        if metric == "precomputed":
            if X.shape[0] != X.shape[1]:
                raise ValueError(
                    f"Distance matrix should be square, got matrix of shape {X.shape}")
            i, j = np.triu_indices(X.shape[0], k=1)
            X = X[i, j]
        elif callable(metric):
            X = metric(X)
            i, j = np.triu_indices(X.shape[0], k=1)
            X = X[i, j]
        if linkage == "single" and not callable(metric) and metric in _MST_METRICS:
            mst = _mst_linkage_core(np.ascontiguousarray(X, np.double), metric)
            mst = mst[np.argsort(mst.T[2], kind="mergesort"), :]
            out = _single_linkage_label(mst)
        else:
            scipy_metric = metric if callable(metric) else _SCIPY_METRIC.get(metric, metric)
            out = hierarchy.linkage(X, method=linkage, metric=scipy_metric)
    return out[:, :2].astype(np.intp), out[:, 2]


def _hc_get_descendent(node, children, n_leaves):
    ind = [node]
    if node < n_leaves:
        return ind
    descendent = []
    n_indices = 1
    while n_indices:
        i = ind.pop()
        if i < n_leaves:
            descendent.append(i)
            n_indices -= 1
        else:
            ind.extend(children[i - n_leaves])
            n_indices += 1
    return descendent


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """scikit-learn's ``_hc_cut``: the tree cut at ``n_clusters``, labels in
    the order of its heap of negated node ids."""
    if n_clusters > n_leaves:
        raise ValueError(
            "Cannot extract more clusters than samples: "
            f"{n_clusters} clusters were given for a tree with {n_leaves} leaves.")
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these_children = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -these_children[0])
        heapq.heappushpop(nodes, -these_children[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        label[_hc_get_descendent(-node, children, n_leaves)] = i
    return label


# ---------------------------------------------------------------------------
# the structured trees (a connectivity graph), as sklearn/cluster/
# _agglomerative.py's ward_tree and linkage_tree with _hierarchical_fast.pyx:
# heap merges on the host over the graph's edges, in scikit-learn's order
# ---------------------------------------------------------------------------

_PAIRED_METRICS = {"euclidean", "l2", "l1", "manhattan", "cityblock", "cosine", "precomputed"}


def _check_connectivity(X, connectivity):
    """The graph as scikit-learn's fit takes it: a callable is called on X;
    a sparse matrix stays sparse, anything else becomes a 2D array."""
    from scipy import sparse

    if callable(connectivity):
        connectivity = connectivity(X)
    if sparse.issparse(connectivity):
        if connectivity.format not in ("csr", "coo", "lil"):
            connectivity = connectivity.tocsr()
        return connectivity
    connectivity = np.asarray(connectivity)
    if connectivity.ndim != 2:
        raise ValueError(f"Expected 2D array, got connectivity of shape {connectivity.shape}")
    return connectivity


def _row_norms(X, squared=False):
    """scikit-learn's ``row_norms`` of a dense float64 array."""
    norms = np.einsum("ij,ij->i", X, X)
    return norms if squared else np.sqrt(norms)


def _normalize(X):
    """scikit-learn's ``normalize`` (l2 rows; near-zero norms left as 1)."""
    norms = _row_norms(X)
    norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
    return X / norms[:, None]


def _nearest_pair(X, idx_i, idx_j, metric, device):
    """(ii, jj): the first smallest entry, in row-major order, of
    scikit-learn's pairwise_distances(X[idx_i], X[idx_j], metric). The
    Euclidean distances (-2 a.b + |a|^2 + |b|^2, clipped at 0, square
    rooted) run on ``device`` in float64 row chunks; the other metrics as
    scikit-learn computes them, on the host."""
    if metric in ("euclidean", "l2"):
        a_sq, b_sq = (torch.as_tensor(_row_norms(X[ix], squared=True), device=device)
                      for ix in (idx_i, idx_j))
        b = torch.as_tensor(X[idx_j], device=device)
        chunk = _row_chunk(len(idx_j), device)
        best, at = None, (0, 0)
        for s in range(0, len(idx_i), chunk):
            rows = slice(s, s + chunk)
            a = torch.as_tensor(X[idx_i[rows]], device=device)
            d = _sq_distances(a, b, a_sq[rows], b_sq).sqrt_()
            flat = int(d.argmin())
            v = float(d.view(-1)[flat])
            if best is None or v < best:
                best, at = v, (s + flat // d.shape[1], flat % d.shape[1])
        return at
    from scipy.spatial.distance import cdist

    Xi, Xj = X[idx_i], X[idx_j]
    if metric == "precomputed":
        D = X[np.ix_(idx_i, idx_j)]
    elif metric == "cosine":
        D = 1.0 - _normalize(Xi) @ _normalize(Xj).T
        np.clip(D, 0, 2, out=D)
    elif callable(metric):
        D = cdist(Xi, Xj, metric=metric)
    else:
        D = cdist(Xi, Xj, metric=_SCIPY_METRIC.get(metric, metric))
    return np.unravel_index(D.argmin(axis=None), D.shape)


def _fix_connectivity(X, connectivity, metric, device):
    """scikit-learn's ``_fix_connectivity``: the graph made symmetric, as a
    LIL matrix, its connected components joined by an edge between the
    nearest pair of points of every two components (with its warning).
    Returns (graph, the number of components before the join)."""
    import warnings

    from scipy import sparse
    from scipy.sparse.csgraph import connected_components

    n = X.shape[0]
    if connectivity.shape[0] != n or connectivity.shape[1] != n:
        raise ValueError(f"Wrong shape for connectivity matrix: {connectivity.shape} "
                         f"when X is {X.shape}")
    connectivity = connectivity + connectivity.T
    if not sparse.issparse(connectivity):
        connectivity = sparse.lil_array(connectivity)
    if connectivity.format != "lil":
        connectivity = connectivity.tolil()
    n_components, labels = connected_components(connectivity)
    if n_components > 1:
        warnings.warn(
            "the number of connected components of the connectivity matrix is "
            f"{n_components} > 1. Completing it to avoid stopping the tree early.",
            stacklevel=3)
        for i in range(n_components):
            idx_i = np.flatnonzero(labels == i)
            for j in range(i):
                idx_j = np.flatnonzero(labels == j)
                ii, jj = _nearest_pair(X, idx_i, idx_j, metric, device)
                connectivity[idx_i[ii], idx_j[jj]] = 1
                connectivity[idx_j[jj], idx_i[ii]] = 1
    return connectivity, n_components


def _ward_dist(m1, m2, rows, cols):
    """``compute_ward_dist``: the inertia gain of merging each (row, col)
    pair of clusters from their moments, the squares summed feature by
    feature in order."""
    rows, cols = np.asarray(rows, np.intp), np.asarray(cols, np.intp)
    n = (m1[rows] * m1[cols]) / (m1[rows] + m1[cols])
    pa = np.zeros(len(rows))
    for j in range(m2.shape[1]):
        pa += (m2[rows, j] / m1[rows] - m2[cols, j] / m1[cols]) ** 2
    return pa * n


def _get_parents(nodes, heads, parents, seen):
    """``_get_parents``: the roots of ``nodes`` not seen yet, appended to
    heads in order."""
    for node in nodes:
        parent = parents[node]
        while parent != node:
            node = parent
            parent = parents[node]
        if node not in seen:
            seen.add(node)
            heads.append(node)


def _n_nodes(n_samples, n_clusters):
    if n_clusters is None:
        return 2 * n_samples - 1
    if n_clusters > n_samples:
        raise ValueError(f"Cannot provide more clusters than samples. {n_clusters} "
                         f"n_clusters was asked, and there are {n_samples} samples.")
    return 2 * n_samples - n_clusters


def _ward_tree_structured(X, connectivity, n_clusters, device):
    """``ward_tree`` with a connectivity graph: (children, the graph's
    component count, parents, distances)."""
    n_samples = X.shape[0]
    connectivity, n_components = _fix_connectivity(X, connectivity, "euclidean", device)
    n_nodes = _n_nodes(n_samples, n_clusters)
    coord_row, coord_col, A = [], [], []
    for ind, row in enumerate(connectivity.rows):
        A.append(list(row))
        lower = [i for i in row if i < ind]
        coord_row.extend([ind] * len(lower))
        coord_col.extend(lower)
    moments_1 = np.zeros(n_nodes)
    moments_1[:n_samples] = 1
    moments_2 = np.zeros((n_nodes, X.shape[1]))
    moments_2[:n_samples] = X
    inertia = list(zip(_ward_dist(moments_1, moments_2, coord_row, coord_col).tolist(),
                       coord_row, coord_col))
    heapq.heapify(inertia)
    parent = list(range(n_nodes))
    used = [True] * n_nodes
    children, distances = [], np.empty(n_nodes - n_samples)
    for k in range(n_samples, n_nodes):
        while True:
            inert, i, j = heapq.heappop(inertia)
            if used[i] and used[j]:
                break
        parent[i] = parent[j] = k
        children.append((i, j))
        used[i] = used[j] = False
        distances[k - n_samples] = inert
        moments_1[k] = moments_1[i] + moments_1[j]
        moments_2[k] = moments_2[i] + moments_2[j]
        cols, seen = [], {k}
        _get_parents(A[i], cols, parent, seen)
        _get_parents(A[j], cols, parent, seen)
        for col in cols:
            A[col].append(k)
        A.append(cols)
        ini = _ward_dist(moments_1, moments_2, [k] * len(cols), cols).tolist()
        for d, col in zip(ini, cols):
            heapq.heappush(inertia, (d, k, col))
    children = np.array([c[::-1] for c in children])
    return children, n_components, np.asarray(parent, np.intp), np.sqrt(2.0 * distances)


class _Edge:
    """``WeightedEdge``: ordered by weight alone, so that the heap breaks
    ties as scikit-learn's does."""

    __slots__ = ("weight", "a", "b")

    def __init__(self, weight, a, b):
        self.weight, self.a, self.b = weight, a, b

    def __lt__(self, other):
        return self.weight < other.weight


def _merge(a, b, used, n_a, n_b, linkage):
    """``max_merge`` / ``average_merge``: the live keys of a and of b, a
    key in both taking the larger, or the size-weighted mean, of the two
    values; in key order."""
    out = {key: v for key, v in a.items() if used[key]}
    for key, v in b.items():
        if not used[key]:
            continue
        if key not in out:
            out[key] = v
        elif linkage == "complete":
            out[key] = max(out[key], v)
        else:
            out[key] = (n_a * out[key] + n_b * v) / (n_a + n_b)
    return dict(sorted(out.items()))


def _paired_distances(X, row, col, metric):
    """``paired_distances(X[row], X[col], metric)`` (or X[row, col] for a
    precomputed X), on the host as scikit-learn computes them."""
    if metric == "precomputed":
        return X[row, col].astype(np.float64, copy=False)
    a, b = X[row], X[col]
    if metric in ("euclidean", "l2"):
        return _row_norms(a - b)
    if metric in ("l1", "manhattan", "cityblock"):
        return np.abs(a - b).sum(axis=-1)
    if metric == "cosine":
        return 0.5 * _row_norms(_normalize(a) - _normalize(b), squared=True)
    if callable(metric):
        return np.array([metric(u, v) for u, v in zip(a, b)], np.float64)
    raise ValueError(f"Unknown distance {metric}")


def _linkage_tree_structured(X, connectivity, linkage, metric, n_clusters, device):
    """``linkage_tree`` with a connectivity graph (complete, average or
    single): (children, the graph's component count, parents, distances)."""
    from scipy.sparse.csgraph import minimum_spanning_tree

    if not (callable(metric) or metric in _PAIRED_METRICS):
        raise ValueError(f"Unknown distance {metric}")
    n_samples = X.shape[0]
    connectivity, n_components = _fix_connectivity(X, connectivity, metric, device)
    connectivity = connectivity.tocoo()
    off = connectivity.row != connectivity.col
    connectivity.row, connectivity.col = connectivity.row[off], connectivity.col[off]
    connectivity.data = _paired_distances(X, connectivity.row, connectivity.col, metric)
    n_nodes = _n_nodes(n_samples, n_clusters)
    if linkage == "single":
        # _single_linkage_tree: scipy's minimum spanning tree, zero
        # weights held at eps meanwhile, as a sorted linkage
        connectivity = connectivity.astype(np.float64, copy=False)
        eps = np.finfo(connectivity.data.dtype).eps
        connectivity.data[connectivity.data == 0] = eps
        mst = minimum_spanning_tree(connectivity.tocsr()).tocoo()
        mst.data[mst.data == eps] = 0
        mst = np.vstack([mst.row, mst.col, mst.data]).T
        mst = mst[np.argsort(mst.T[2], kind="mergesort"), :]
        tree = _single_linkage_label(mst)
        children = tree[:, :2].astype(int)
        parent = np.arange(n_nodes, dtype=np.intp)
        for i, (left, right) in enumerate(children, n_samples):
            if n_clusters is not None and i >= n_nodes:
                break
            if left < n_nodes:
                parent[left] = i
            if right < n_nodes:
                parent[right] = i
        return children, n_components, parent, tree[:, 2]
    connectivity = connectivity.tolil()
    A: list = [None] * n_nodes
    inertia = []
    for ind, (data, row) in enumerate(zip(connectivity.data, connectivity.rows)):
        A[ind] = dict(sorted(zip(row, map(float, data))))
        inertia.extend(_Edge(float(d), ind, r) for r, d in zip(row, data) if r < ind)
    heapq.heapify(inertia)
    parent = list(range(n_nodes))
    used = [1] * n_samples + [0] * (n_nodes - n_samples)
    children, distances = [], np.empty(n_nodes - n_samples)
    for k in range(n_samples, n_nodes):
        while True:
            edge = heapq.heappop(inertia)
            if used[edge.a] and used[edge.b]:
                break
        i, j = edge.a, edge.b
        distances[k - n_samples] = edge.weight
        parent[i] = parent[j] = k
        children.append((i, j))
        n_i, n_j = used[i], used[j]
        used[k] = n_i + n_j
        used[i] = used[j] = 0
        merged = _merge(A[i], A[j], used, n_i, n_j, linkage)
        for col, d in merged.items():
            A[col][k] = d
            heapq.heappush(inertia, _Edge(d, k, col))
        A[k] = merged
        A[i] = A[j] = None
    children = np.array(children)[:, ::-1]
    return children, n_components, np.asarray(parent, np.intp), distances


def _hc_get_heads(parents):
    """``hc_get_heads``: each node's root in the forest of parents."""
    parents = list(parents)
    for node0 in range(len(parents) - 1, -1, -1):
        node = node0
        parent = parents[node]
        while parent != node:
            parents[node0] = parent
            node = parent
            parent = parents[node]
    return np.asarray(parents, np.intp)


class AgglomerativeClusteringWithMinSize:
    """Agglomerative clustering with a minimum cluster size: points of
    undersized clusters are reassigned to the nearest valid cluster
    (``helicon_tpu/clustering.py``, without scikit-learn).

    The constructor's arguments are scikit-learn's ``AgglomerativeClustering``
    ones; ``fit`` sets ``labels_``, ``n_clusters_``, ``children_``,
    ``n_leaves_`` and, with ``distance_threshold``, ``distances_``. The
    reassignment's distances (Euclidean on the rows of X, as the reference's
    ``pairwise_distances(X)``) run on ``device`` in float64; a float32 X is
    taken in float64. A ``connectivity`` graph (an array, a sparse matrix
    or a callable of X) builds scikit-learn's structured tree on the host
    (heap merges over the graph's edges, its early stop under n_clusters
    with compute_full_tree "auto" or False), its components joined by their
    nearest pairs, whose Euclidean distances run on ``device``.
    """

    def __init__(self, min_cluster_size: int = 2, n_clusters: int = 2,
                 metric: str = "euclidean", memory=None, connectivity=None,
                 compute_full_tree="auto", linkage: str = "ward",
                 distance_threshold=None, *, device="cuda"):
        self.min_cluster_size = min_cluster_size
        self.n_clusters = n_clusters
        self.metric = metric
        self.memory = memory
        self.connectivity = connectivity
        self.compute_full_tree = compute_full_tree
        self.linkage = linkage
        self.distance_threshold = distance_threshold
        self.device = device

    def _fit_tree(self, X):
        if not ((self.n_clusters is None) ^ (self.distance_threshold is None)):
            raise ValueError(
                "Exactly one of n_clusters and "
                "distance_threshold has to be set, and the other "
                "needs to be None.")
        if self.distance_threshold is not None and not self.compute_full_tree:
            raise ValueError("compute_full_tree must be True if distance_threshold is set.")
        if self.linkage not in ("ward", "complete", "average", "single"):
            raise ValueError(f"Unknown linkage type {self.linkage!r}")
        if self.linkage == "ward" and self.metric not in ("euclidean", "l2"):
            raise ValueError(
                f"{self.metric} was provided as metric. Ward can only "
                "work with euclidean distances (i.e. 'euclidean' and 'l2').")
        connectivity, compute_full_tree = self.connectivity, self.compute_full_tree
        if connectivity is None:
            compute_full_tree = True
        else:
            connectivity = _check_connectivity(X, connectivity)
        if compute_full_tree == "auto":
            # scikit-learn's heuristic: an early stop pays only for many clusters
            compute_full_tree = (self.distance_threshold is not None
                                 or self.n_clusters < max(100, 0.02 * len(X)))
        n_clusters = None if compute_full_tree else self.n_clusters
        if connectivity is None:
            children, distances = _linkage_tree(X, self.linkage, self.metric)
            n_components, parents = 1, None
        elif self.linkage == "ward":
            children, n_components, parents, distances = _ward_tree_structured(
                X, connectivity, n_clusters, self.device)
        else:
            children, n_components, parents, distances = _linkage_tree_structured(
                X, connectivity, self.linkage, self.metric, n_clusters, self.device)
        self.children_ = children
        self.n_connected_components_ = n_components
        self.n_leaves_ = len(X)
        if self.distance_threshold is not None:
            self.distances_ = distances
            self.n_clusters_ = int(np.count_nonzero(distances >= self.distance_threshold)) + 1
        else:
            self.n_clusters_ = self.n_clusters
        if compute_full_tree:
            return _hc_cut(self.n_clusters_, children, self.n_leaves_)
        # the early stop: each sample's root in the partial tree, renumbered
        labels = _hc_get_heads(parents)[: len(X)]
        return np.searchsorted(np.unique(labels), labels)

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 2 or len(X) < 2:
            raise ValueError(
                f"Found array with {len(X)} sample(s) (shape={X.shape}) while a "
                "minimum of 2 is required by AgglomerativeClusteringWithMinSize.")
        self.n_features_in_ = X.shape[1]
        labels = self._fit_tree(X)
        xd = sq = None
        while True:
            unique, counts = np.unique(labels, return_counts=True)
            if len(unique) < 3:
                break
            small = unique[counts < self.min_cluster_size]
            if len(small) == 0:
                break
            if len(small) == len(unique):
                smallest_two = unique[np.argsort(counts)[:2]]
                labels[labels == smallest_two[1]] = smallest_two[0]
                continue
            if xd is None:
                xd = torch.as_tensor(X, device=self.device)
                sq = (xd * xd).sum(1)
            labels = _reassign_small(xd, sq, labels, small)
        self.labels_ = labels
        self.n_clusters_ = len(np.unique(labels))
        return self

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_


def _reassign_small(xd, sq, labels, small):
    """The reference's sequential loop: each point of each small cluster, in
    order, takes the label of its nearest point outside the small clusters
    (the set grows as points move). One masked argmin on the device per
    point over its row of the distance table (rows made in chunks)."""
    n = len(labels)
    points = np.concatenate([np.where(labels == sc)[0] for sc in small])
    valid = torch.as_tensor(~np.isin(labels, small), device=xd.device)
    chunk = _row_chunk(n, xd.device)
    inf = torch.tensor(float("inf"), dtype=xd.dtype, device=xd.device)
    for s in range(0, len(points), chunk):
        rows = points[s:s + chunk]
        idx = torch.as_tensor(rows, device=xd.device)
        d = _sq_distances(xd[idx], xd, sq[idx], sq).sqrt_()
        for r, point in enumerate(rows):
            j = int(torch.where(valid, d[r], inf).argmin())
            labels[point] = labels[j]
            valid[point] = True
    return labels


# ---------------------------------------------------------------------------
# k-means, as sklearn/cluster/_kmeans.py (KMeans, init k-means++, lloyd)
# ---------------------------------------------------------------------------


def _kmeans_plusplus(xd, x_sq, n_clusters: int, rs: np.random.RandomState):
    """``_kmeans_plusplus`` with unit weights: the draws on the host, the
    distances on the device."""
    n = xd.shape[0]
    w = np.ones(n)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = rs.choice(n, p=w / w.sum())
    # the trials' draws of every later centre, in scikit-learn's order
    draws = torch.as_tensor(rs.uniform(size=(n_clusters - 1) * n_local_trials),
                            device=xd.device).view(-1, n_local_trials)
    indices = [torch.tensor([center_id], device=xd.device)]
    closest = _sq_distances(xd[center_id][None], xd, x_sq[center_id][None], x_sq)[0]
    pot = closest.sum()
    for c in range(1, n_clusters):
        cand = torch.searchsorted(torch.cumsum(closest, 0), draws[c - 1] * pot)
        cand.clamp_(max=n - 1)
        d = _sq_distances(xd[cand], xd, x_sq[cand], x_sq)
        torch.minimum(closest[None], d, out=d)
        pots = d.sum(1)
        best = pots.argmin()
        pot, closest = pots[best], d[best]
        indices.append(cand[best][None])
    return xd[torch.cat(indices)].clone()


def _relocate_empty(x, centers_old, sums, weight, labels):
    """``_relocate_empty_clusters_dense`` on the host (numpy, unit weights)."""
    empty = np.where(np.equal(weight, 0))[0]
    n_empty = len(empty)
    distances = ((x - centers_old[labels]) ** 2).sum(axis=1)
    far = np.argpartition(distances, -n_empty)[:-n_empty - 1:-1]
    if np.max(distances) == 0:
        return sums, weight
    for new_id, far_idx in zip(empty, far):
        old_id = labels[far_idx]
        sums[old_id] -= x[far_idx]
        sums[new_id] = x[far_idx]
        weight[new_id] = 1.0
        weight[old_id] -= 1.0
    return sums, weight


def _assign(xd, centers):
    """Labels by the least ||c||^2 - 2 x.c, the first centre on a tie."""
    c_sq = (centers * centers).sum(1)
    return torch.addmm(c_sq.expand(xd.shape[0], -1), xd, centers.T, alpha=-2).argmin(1)


def _lloyd(xd, centers, tol: float):
    """``_kmeans_single_lloyd``: (labels, inertia, centers)."""
    n, k = xd.shape[0], centers.shape[0]
    labels_old = torch.full((n,), -1, dtype=torch.long, device=xd.device)
    strict = False
    for _ in range(KMEANS_MAX_ITER):
        labels = _assign(xd, centers)
        weight = torch.bincount(labels, minlength=k).to(xd.dtype)
        sums = torch.zeros_like(centers).index_add_(0, labels, xd)
        changed, empty = torch.stack([(labels != labels_old).any(), (weight == 0).any()]).tolist()
        if empty:
            s, w = _relocate_empty(xd.cpu().numpy(), centers.cpu().numpy(), sums.cpu().numpy(),
                                   weight.cpu().numpy(), labels.cpu().numpy())
            sums = torch.as_tensor(s, device=xd.device)
            weight = torch.as_tensor(w, device=xd.device)
        new = sums * (1.0 / weight)[:, None]
        live = weight > 0
        if not bool(live.all()):
            # _average_centers: an empty centre takes the heaviest one's,
            # averaged only where that one comes earlier in the loop
            big = int(weight.argmax())
            for j in torch.nonzero(~live).flatten().tolist():
                new[j] = new[big] if j > big else sums[big]
        shift = ((new - centers) ** 2).sum(1).sqrt()
        centers = new
        if not changed:
            strict = True
            break
        if float((shift ** 2).sum()) <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(xd, centers)
    inertia = float(((xd - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _is_same_clustering(labels1, labels2, n_clusters):
    """``_is_same_clustering``: labels2 is a function of labels1."""
    mapping = np.full(n_clusters, -1)
    _, first = np.unique(labels1, return_index=True)
    mapping[labels1[first]] = labels2[first]
    return bool(np.array_equal(mapping[labels1], labels2))


def kmeans(X, n_clusters: int, *, n_init: int = 10, device="cuda"):
    """scikit-learn's ``KMeans(n_clusters, n_init=n_init,
    random_state=0).fit(X)`` (k-means++, Lloyd, unit weights):
    (labels as int32, inertia, centres), computed on ``device``. X is
    centred on its mean first and the tolerance scaled by the mean of the
    per-feature variances, as scikit-learn does."""
    X = np.asarray(X, dtype=np.float64)
    if len(X) < n_clusters:
        raise ValueError(f"n_samples={len(X)} should be >= n_clusters={n_clusters}.")
    mean = X.mean(axis=0)
    tol = float(np.mean(np.var(X, axis=0))) * KMEANS_TOL
    xd = torch.as_tensor(X - mean, device=device)
    x_sq = (xd * xd).sum(1)
    rs = np.random.RandomState(KMEANS_SEED)
    best = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(xd, x_sq, n_clusters, rs)
        labels, inertia, centers = _lloyd(xd, centers, tol)
        labels = labels.cpu().numpy().astype(np.int32)
        if best is None or (inertia < best[1]
                            and not _is_same_clustering(labels, best[0], n_clusters)):
            best = (labels, inertia, centers)
    labels, inertia, centers = best
    return labels, inertia, centers.cpu().numpy() + mean


def silhouette_score(X, labels, *, device="cuda") -> float:
    """scikit-learn's ``silhouette_score(X, labels)`` (Euclidean): per sample
    a, the mean distance to its own cluster's other members, and b, the least
    mean distance to another cluster; (b - a) / max(a, b), 0 for a singleton;
    the mean after ``nan_to_num``. Pair distances in float64 on ``device``,
    in chunks of rows sized to the free memory."""
    x = torch.as_tensor(np.asarray(X, np.float64), device=device)
    uniq, enc = np.unique(np.asarray(labels), return_inverse=True)
    n, n_labels = len(enc), len(uniq)
    if not 1 < n_labels < n:
        raise ValueError(
            f"Number of labels is {n_labels}. Valid values are 2 to n_samples - 1 (inclusive)")
    freqs = torch.as_tensor(np.bincount(enc), dtype=x.dtype, device=x.device)
    enc_t = torch.as_tensor(enc, device=x.device)
    onehot = torch.zeros(n, n_labels, dtype=x.dtype, device=x.device)
    onehot[torch.arange(n, device=x.device), enc_t] = 1.0
    sq = (x * x).sum(1)
    intra, inter = [], []
    chunk = _row_chunk(n, x.device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        rows = torch.arange(e - s, device=x.device)
        d = _sq_distances(x[s:e], x, sq[s:e], sq)
        d[rows, rows + s] = 0
        clust = d.sqrt_() @ onehot
        own = enc_t[s:e]
        intra.append(clust[rows, own])
        clust[rows, own] = float("inf")
        inter.append((clust / freqs).min(1).values)
    a = torch.cat(intra) / (freqs - 1)[enc_t]
    b = torch.cat(inter)
    sil = torch.nan_to_num((b - a) / torch.maximum(a, b))
    return float(sil.mean())
