"""The PyTorch port's search drivers with pose refinement against the JAX
package: the bucketed search (refinement in the buckets, the refined poses
merged, the second pass without refinement, the winner refined again) and
the checkpointed search (top-k deferred to bucket geometry; "all" inside
each chunk, its poses in the shard).

As tests/test_torch_refine_grid.py (whose helpers this file shares): the
small workload of tests/_mh_worker.py, its JAX searches eager, the
reference's engine bounds (poses 5e-3, scores 5e-4) on refined candidates
and 1e-4 on the others.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from helicon_tpu.denovo3d import checkpoint as ref_checkpoint
from helicon_tpu_torch.denovo3d import reconstruct_grid_checkpointed
from test_torch_refine_grid import ALL, RANGE, _native_cache, _port, _ref, _same_refined, \
    _same_scores, _tiny  # noqa: F401 (_native_cache: an autouse fixture)


def test_bucketed_search_merges_refined_poses(monkeypatch):
    """Two rise buckets, each refining its top candidate; the second pass
    runs without refinement; the winner is refined again alone, its pose
    merged. The second pass's calls of one candidate per twist take the
    grouped route in both packages (HELICON_GRID_GROUPED=1; the eager
    per-candidate path of the reference costs seven times as much, with the
    same scores: tests/test_torch_grid.py)."""
    monkeypatch.setenv("HELICON_GRID_GROUPED", "1")
    image, tw, ri, kw = _tiny(bucketed=True, refine_tilt_psi_dy_range=dict(RANGE, max_iter=1),
                              return_best_volume=True)
    # three candidates, rises 3.0, 3.2 and 5.6 A: two buckets
    tw, ri = tw[[0, 2, 4]], ri[[0, 2, 4]]
    port, ref = _port(image, tw, ri, **kw), _ref(image, tw, ri, **kw)
    assert port.effective["n_buckets"] == 2
    _same_refined(port, ref)
    np.testing.assert_allclose(port.scores, ref.scores, rtol=0, atol=5e-4)
    assert port.best_index == ref.best_index
    assert port.best_index in port.refined_params
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("mode", ["topk", "all"])
def test_checkpointed_refine_matches_reference(mode, tmp_path):
    """The checkpointed search (the pattern of tests/test_checkpoint.py):
    scores, refined poses and winner as the reference's, and the shard's
    poses as the reference writes them (topk: the coarse pass only, no
    poses; all: every chunk's). No best volume: the winner's re-solve is
    the one-shot search's, tested above."""
    image, tw, ri, kw = _tiny(refine_tilt_psi_dy_range=dict(RANGE, max_iter=1),
                              **(dict(refine_top_k=2) if mode == "topk" else ALL))
    tw, ri = tw[2:6], ri[2:6]
    with jax.disable_jit():
        ref = ref_checkpoint.reconstruct_grid_checkpointed(
            image, twists=tw, rises=ri, checkpoint_path=str(tmp_path / "ref.npz"), chunk=2,
            devices=jax.devices()[:1], **kw)
    port = reconstruct_grid_checkpointed(image, twists=tw, rises=ri,
                                         checkpoint_path=str(tmp_path / "port.npz"), chunk=2,
                                         device="cpu", **kw)
    _same_refined(port, ref)
    _same_scores(port, ref)
    assert port.best_index == ref.best_index
    z_ref, z_port = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(z_port["pose_mask"], z_ref["pose_mask"])
    np.testing.assert_allclose(z_port["pose"], z_ref["pose"], rtol=0, atol=5e-3)
    assert z_port["pose_mask"].all() == (mode == "all")
