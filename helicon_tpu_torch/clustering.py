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
  the label numbers;
- the reassignment of undersized clusters, Lloyd's iterations and the
  silhouette's pair distances run on ``device`` in float64, with
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


class AgglomerativeClusteringWithMinSize:
    """Agglomerative clustering with a minimum cluster size: points of
    undersized clusters are reassigned to the nearest valid cluster
    (``helicon_tpu/clustering.py``, without scikit-learn).

    The constructor's arguments are scikit-learn's ``AgglomerativeClustering``
    ones; ``fit`` sets ``labels_``, ``n_clusters_``, ``children_``,
    ``n_leaves_`` and, with ``distance_threshold``, ``distances_``. The
    reassignment's distances (Euclidean on the rows of X, as the reference's
    ``pairwise_distances(X)``) run on ``device`` in float64; a float32 X is
    taken in float64. A ``connectivity`` graph needs scikit-learn's
    structured tree and raises (ROADMAP A12.4b).
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
        if self.connectivity is not None:
            raise NotImplementedError(
                "AgglomerativeClusteringWithMinSize: a connectivity graph needs "
                "scikit-learn's structured tree, not ported yet (ROADMAP A12.4b)")
        children, distances = _linkage_tree(X, self.linkage, self.metric)
        self.children_ = children
        self.n_connected_components_ = 1
        self.n_leaves_ = len(X)
        if self.distance_threshold is not None:
            self.distances_ = distances
            self.n_clusters_ = int(np.count_nonzero(distances >= self.distance_threshold)) + 1
        else:
            self.n_clusters_ = self.n_clusters
        return _hc_cut(self.n_clusters_, children, self.n_leaves_)

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
