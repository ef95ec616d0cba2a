"""Clustering in the PyTorch port against the JAX package, whose
reference runs scikit-learn: ``AgglomerativeClusteringWithMinSize`` (every
linkage, with n_clusters and with distance_threshold, the sequential
reassignment of undersized clusters and the merge of the two smallest),
``assign_beamshifts_to_cluster`` on seeded multi-shot beam-shift patterns
(labels exactly equal), the structured trees of a connectivity graph
against scikit-learn's (labels and children equal, distances within 1e-12) and the port's k-means and silhouette against
scikit-learn's (labels equal, the silhouette within 1e-9). A subprocess
checks that none of it imports scikit-learn."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from helicon_tpu import clustering as ref_clustering
from helicon_tpu.io import metadata as ref_md
from helicon_tpu_torch import clustering
from helicon_tpu_torch.io import metadata

ROOT = Path(__file__).resolve().parents[1]


def _multishot(holes=3, shots=4, per=3, jitter=0.02, spacing=0.05, seed=0):
    """holes x holes foil holes on a grid of 2.5 shot spacings, ``shots``
    exposures in each (at +/- spacing / 2 about its centre), ``per`` movies
    at each position, jitter a fraction of the spacing; (shifts, true
    position)."""
    g = np.random.default_rng(seed)
    offsets = [(-1, -1), (-1, 1), (1, -1), (1, 1)][:shots]
    pos = np.array([(hx * 5 + sx, hy * 5 + sy) for hx in range(holes) for hy in range(holes)
                    for sx, sy in offsets], np.float64) * spacing / 2 + (0.31, -0.17)
    truth = np.repeat(np.arange(len(pos)), per)
    return pos[truth] + g.normal(0, jitter * spacing, (len(truth), 2)), truth


def _blobs(seed=0):
    g = np.random.default_rng(seed)
    return np.concatenate([g.normal(0, 0.3, (12, 3)), g.normal(3, 0.3, (10, 3)),
                           g.normal([0, 3, 0], 0.3, (9, 3)), g.normal(6, 0.5, (4, 3)),
                           g.normal([6, 0, 6], 0.3, (2, 3))])


AGGLO = [(link, kw) for link in ("ward", "complete", "average", "single")
         for kw in (dict(n_clusters=5), dict(n_clusters=None, distance_threshold=1.5))]


@pytest.mark.parametrize("linkage,kw", AGGLO,
                         ids=[f"{l}-{'n' if 'n_clusters' in k and k['n_clusters'] else 't'}"
                              for l, k in AGGLO])
@pytest.mark.parametrize("min_size", [1, 5])
def test_agglomerative_matches_reference(linkage, kw, min_size):
    """Every linkage, cut by count or by distance, with and without the
    reassignment of clusters under 5 points: labels and n_clusters_ equal."""
    X = _blobs()
    want = ref_clustering.AgglomerativeClusteringWithMinSize(
        min_cluster_size=min_size, linkage=linkage, **kw).fit(X)
    got = clustering.AgglomerativeClusteringWithMinSize(
        min_cluster_size=min_size, linkage=linkage, device="cpu", **kw).fit(X)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.n_clusters_ == want.n_clusters_


def test_agglomerative_sequential_reassignment():
    """Two small clusters whose points move one at a time: a point moved
    earlier becomes a target for the points after it (the reference's
    order), so the labels depend on that order."""
    g = np.random.default_rng(3)
    X = np.concatenate([g.normal(0, 0.2, (15, 2)), g.normal(5, 0.2, (15, 2)),
                        [[2.0, 2.0], [2.3, 2.3], [2.6, 2.6]], [[7.0, 0.0]]])
    want = ref_clustering.AgglomerativeClusteringWithMinSize(
        min_cluster_size=5, n_clusters=4, linkage="single").fit(X)
    got = clustering.AgglomerativeClusteringWithMinSize(
        min_cluster_size=5, n_clusters=4, linkage="single", device="cpu").fit(X)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.n_clusters_ == want.n_clusters_ == 2


def test_agglomerative_merges_the_two_smallest():
    """tests/test_aux_modules.py's data at min size 25: every cluster is
    small, so the two smallest merge until fewer than three remain."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 0.1, (20, 2)), rng.normal(5, 0.1, (20, 2)),
                        rng.normal([0, 5], 0.1, (3, 2))])
    for size in (5, 25):
        want = ref_clustering.AgglomerativeClusteringWithMinSize(
            min_cluster_size=size, n_clusters=3).fit(X)
        got = clustering.AgglomerativeClusteringWithMinSize(
            min_cluster_size=size, n_clusters=3, device="cpu").fit(X)
        np.testing.assert_array_equal(got.labels_, want.labels_)
        assert got.n_clusters_ == want.n_clusters_


def test_agglomerative_arguments_raise_as_reference():
    X = _blobs()
    for kw in (dict(n_clusters=None), dict(n_clusters=3, distance_threshold=1.0),
               dict(linkage="ward", metric="manhattan")):
        with pytest.raises(ValueError):
            ref_clustering.AgglomerativeClusteringWithMinSize(**kw).fit(X)
        with pytest.raises(ValueError):
            clustering.AgglomerativeClusteringWithMinSize(device="cpu", **kw).fit(X)
    # a connectivity graph is ported (ROADMAP A12.4b): one of the wrong
    # shape raises as scikit-learn's does
    for cls, kw in ((ref_clustering.AgglomerativeClusteringWithMinSize, {}),
                    (clustering.AgglomerativeClusteringWithMinSize, dict(device="cpu"))):
        with pytest.raises(ValueError, match="Wrong shape for connectivity"):
            cls(connectivity=np.eye(len(X) - 1), **kw).fit(X)


def _structured_data(seed=0):
    """125 points in four blobs of 3D, and a 6-nearest-neighbour graph with
    the edges between the first 75 points and the rest cut (two
    components)."""
    from sklearn.neighbors import kneighbors_graph

    g = np.random.default_rng(seed)
    X = np.concatenate([g.normal(0, 0.3, (40, 3)), g.normal(3, 0.3, (35, 3)),
                        g.normal([0, 3, 0], 0.3, (30, 3)), g.normal(6, 0.5, (20, 3))])
    knn = kneighbors_graph(X, 6, include_self=False)
    part = np.r_[np.zeros(75, int), np.ones(50, int)]
    two = knn.tolil()
    rows, cols = two.nonzero()
    for r, c in zip(rows, cols):
        if part[r] != part[c]:
            two[r, c] = 0
    two = two.tocsr()
    two.eliminate_zeros()
    return X, dict(knn=knn, dense=knn.toarray(), two_components=two,
                   callable=lambda x: kneighbors_graph(x, 5, include_self=True))


STRUCTURED_CUTS = dict(
    full=dict(n_clusters=5, compute_full_tree=True),
    early=dict(n_clusters=5, compute_full_tree=False),
    auto_early=dict(n_clusters=110),  # "auto": an early stop past 100 clusters
    threshold=dict(n_clusters=None, distance_threshold=1.0),
)


@pytest.mark.parametrize("cut", sorted(STRUCTURED_CUTS))
@pytest.mark.parametrize("graph", ["knn", "dense", "two_components", "callable"])
@pytest.mark.parametrize("linkage", ["ward", "complete", "average", "single"])
def test_structured_tree_matches_sklearn(linkage, graph, cut):
    """A connectivity graph (sparse, dense, of two components, a callable):
    scikit-learn's structured tree label for label, children_ equal,
    distances_ within 1e-12, n_connected_components_ and the warning of a
    graph of several components."""
    import warnings

    from sklearn.cluster import AgglomerativeClustering

    X, graphs = _structured_data()
    kw = dict(linkage=linkage, connectivity=graphs[graph], **STRUCTURED_CUTS[cut])
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        want = AgglomerativeClustering(**kw).fit(X)
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        got = clustering.AgglomerativeClusteringWithMinSize(min_cluster_size=1, device="cpu",
                                                            **kw).fit(X)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_array_equal(got.children_, want.children_)
    assert got.n_connected_components_ == want.n_connected_components_
    assert got.n_clusters_ == want.n_clusters_
    if cut == "threshold":
        np.testing.assert_allclose(got.distances_, want.distances_, rtol=0, atol=1e-12)
    several = [str(x.message) for x in w_ref if "connected components" in str(x.message)]
    assert several == [str(x.message) for x in w_got
                       if "connected components" in str(x.message)]
    assert bool(several) == (want.n_connected_components_ > 1)


@pytest.mark.parametrize("metric", ["manhattan", "cosine", "precomputed"])
def test_structured_tree_other_metrics_match_sklearn(metric):
    """Average linkage over the graph of two components under the other
    metrics: the pairs that join the components and the edge distances
    as scikit-learn's."""
    from sklearn.cluster import AgglomerativeClustering

    X, graphs = _structured_data(1)
    data = X if metric != "precomputed" else np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    kw = dict(linkage="average", metric=metric, connectivity=graphs["two_components"],
              n_clusters=None, distance_threshold=0.5)
    want = AgglomerativeClustering(**kw).fit(data)
    got = clustering.AgglomerativeClusteringWithMinSize(min_cluster_size=1, device="cpu",
                                                        **kw).fit(data)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.distances_, want.distances_, rtol=0, atol=1e-12)


@pytest.mark.parametrize("linkage", ["ward", "average"])
def test_structured_tree_with_min_size_matches_reference(linkage):
    """The reference class with a graph and a minimum size of 5: the tree's
    clusters under 5 points reassigned as the reference does."""
    X, graphs = _structured_data(2)
    kw = dict(min_cluster_size=5, n_clusters=12, linkage=linkage,
              connectivity=graphs["two_components"])
    want = ref_clustering.AgglomerativeClusteringWithMinSize(**kw).fit(X)
    got = clustering.AgglomerativeClusteringWithMinSize(device="cpu", **kw).fit(X)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.n_clusters_ == want.n_clusters_


@pytest.mark.parametrize("k", [2, 3, 7, 12, 36, 40])
def test_kmeans_and_silhouette_match_sklearn(k):
    """KMeans(k, n_init=3, random_state=0) label for label, and the
    silhouette of its labels within 1e-9."""
    from sklearn.cluster import KMeans
    from sklearn.metrics import silhouette_score

    X, _ = _multishot()
    km = KMeans(n_clusters=k, n_init=3, random_state=0).fit(X)
    labels, inertia, centers = clustering.kmeans(X, k, n_init=3, device="cpu")
    np.testing.assert_array_equal(labels, km.labels_)
    assert inertia == pytest.approx(km.inertia_, rel=1e-9)
    np.testing.assert_allclose(centers, km.cluster_centers_, rtol=0, atol=1e-12)
    want = silhouette_score(X, km.labels_)
    assert abs(clustering.silhouette_score(X, labels, device="cpu") - want) < 1e-9


def test_silhouette_singletons_and_label_checks():
    """A singleton cluster scores 0; fewer than 2 or n labels raise."""
    from sklearn.metrics import silhouette_score

    X = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0], [9.0, 0.0]])
    labels = np.array([0, 0, 3, 3, 7])
    assert abs(clustering.silhouette_score(X, labels, device="cpu")
               - silhouette_score(X, labels)) < 1e-12
    for bad in (np.zeros(5, int), np.arange(5)):
        with pytest.raises(ValueError):
            clustering.silhouette_score(X, bad, device="cpu")


BEAMSHIFT = dict(
    given_9x4=(dict(holes=3, shots=4, per=3), dict(n_clusters=36)),
    search_9x4=(dict(holes=3, shots=4, per=3), dict(range_n_clusters=range(2, 200))),
    search_min_size=(dict(holes=3, shots=4, per=4, seed=1),
                     dict(range_n_clusters=range(2, 200), min_cluster_size=4)),
    search_default_range=(dict(holes=2, shots=3, per=4, seed=2), dict()),
)


@pytest.mark.parametrize("name", sorted(BEAMSHIFT))
def test_assign_beamshifts_matches_reference(name):
    """Seeded 9-hole x 4-shot patterns (2 % jitter): the reference's
    scikit-learn labels exactly, with n_clusters given and searched by the
    silhouette over range(2, 200), as cryoSPARC's exposure grouping calls
    it; the search recovers the true positions."""
    pattern, kw = BEAMSHIFT[name]
    X, truth = _multishot(**pattern)
    want = ref_md.assign_beamshifts_to_cluster(X, **kw)
    got = metadata.assign_beamshifts_to_cluster(X, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert len(np.unique(got)) == len(np.unique(truth))
    for t in np.unique(truth):
        assert len(np.unique(got[truth == t])) == 1


def test_no_sklearn_import():
    """Importing clustering and io.metadata and calling both functions
    (the clustering with and without a connectivity graph) leaves
    scikit-learn out of sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "from helicon_tpu_torch import clustering\n"
        "from helicon_tpu_torch.io import metadata\n"
        "g = np.random.default_rng(0)\n"
        "X = np.concatenate([g.normal(0, .01, (6, 2)), g.normal(1, .01, (6, 2)), "
        "g.normal(2, .01, (6, 2))])\n"
        "print(metadata.assign_beamshifts_to_cluster(X, device='cpu').tolist())\n"
        "print(clustering.AgglomerativeClusteringWithMinSize(n_clusters=3, device='cpu')"
        ".fit(X).labels_.tolist())\n"
        "chain = np.eye(18, k=1) + np.eye(18, k=-1)\n"
        "print(clustering.AgglomerativeClusteringWithMinSize(n_clusters=3, device='cpu', "
        "connectivity=chain).fit(X).labels_.tolist())\n"
        "assert 'sklearn' not in sys.modules and 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
