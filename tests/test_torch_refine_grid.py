"""The PyTorch port's grid search with pose refinement against the JAX
package: reconstruct_grid with refine_mode "topk" and "all" on both of the
reference's refine routes (tests/test_torch_drivers.py holds the bucketed
search with refinement, tests/test_torch_refine.py the checkpointed one).

The small workload of tests/_mh_worker.py, its JAX searches eager
(jax.disable_jit(), one device) as in tests/test_torch_drivers.py. The
default config takes the reference's C++ engine for refinement (poses 5e-3
deg / px, scores 5e-4: its own engine-vs-JAX bounds,
tests/test_native_refine.py); the candidates refinement leaves alone hold
the search's 1e-4.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from _mh_worker import tiny_workload
from helicon_tpu.denovo3d import reconstruct_grid as ref_reconstruct_grid
from helicon_tpu_torch.denovo3d import reconstruct_grid

RANGE = dict(tilt=4.0, psi=2.0, dy=1.0, max_iter=2)


@pytest.fixture(autouse=True)
def _native_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("HELICON_NATIVE_CACHE", str(tmp_path_factory.getbasetemp() / "native"))


def _tiny(bucketed=False, **kw):
    image, tw, ri, base = tiny_workload(bucketed)
    return np.array(image, np.float32), tw, ri, dict(base, **kw)


def _ref(image, tw, ri, **kw):
    with jax.disable_jit():
        return ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)


def _port(image, tw, ri, **kw):
    return reconstruct_grid(image, twists=tw, rises=ri, device="cpu", **kw)


def _same_refined(port, ref, atol=5e-3):
    assert port.refined_params is not None and ref.refined_params is not None
    assert sorted(port.refined_params) == sorted(ref.refined_params)
    for k, v in ref.refined_params.items():
        np.testing.assert_allclose(port.refined_params[k], v, rtol=0, atol=atol)


def _same_scores(port, ref):
    """Refined candidates within 5e-4, the others within 1e-4."""
    refined = np.zeros(len(ref.scores), bool)
    refined[list(ref.refined_params)] = True
    np.testing.assert_allclose(port.scores[refined], ref.scores[refined], rtol=0, atol=5e-4)
    np.testing.assert_allclose(port.scores[~refined], ref.scores[~refined], rtol=0, atol=1e-4)


# refine_mode "all" in linear interpolation: with nn the reference's engine
# (compiled -O3 -march=native, so with contracted multiply-adds, and its own
# float32 cos) rounds half-way samples apart from its JAX loop, and on this
# workload's third candidate its refined pose lands on another pose than
# its JAX loop's (eager _refine_batch), which the port's follows; linear
# samples do not jump
ALL = dict(refine_mode="all", interpolation="linear", cg_iters=5, fista_iters=5)
SEARCHES = dict(topk=dict(refine_top_k=2), all=ALL)


@pytest.fixture(scope="module", params=sorted(SEARCHES))
def refined_search(request):
    image, tw, ri, kw = _tiny(refine_tilt_psi_dy_range=RANGE, return_best_volume=True,
                              **SEARCHES[request.param])
    if request.param == "all":  # four candidates: linear's plain sampler is slow
        tw, ri = tw[2:6], ri[2:6]
    return request.param, _port(image, tw, ri, **kw), _ref(image, tw, ri, **kw)


def test_refined_search_matches_reference(refined_search):
    mode, port, ref = refined_search
    _same_refined(port, ref)
    assert len(port.refined_params) == (2 if mode == "topk" else len(ref.scores))
    _same_scores(port, ref)
    assert port.best_index == ref.best_index
    assert port.effective["refine_mode"] == mode


def test_best_volume_at_the_refined_pose(refined_search):
    """The winner's volume is solved at its refined pose (non-separable),
    as the reference's."""
    _, port, ref = refined_search
    assert port.best_index in port.refined_params
    rel = np.abs(port.best_volume - ref.best_volume).max() / np.abs(ref.best_volume).max()
    assert rel < 1e-4, rel


def test_refine_all_skips_the_fixed_pose_pass():
    """refine_mode="all" without progress plumbing scores nothing at the
    fixed pose: no scoring path runs, only refinement."""
    image, tw, ri, kw = _tiny(refine_tilt_psi_dy_range=dict(RANGE, max_iter=1),
                              refine_mode="all")
    port = _port(image, tw[:2], ri[:2], **kw)
    assert port.effective["path"] == "refine_all"
    assert sorted(port.refined_params) == [0, 1]


def test_loop_route_search_matches_reference(monkeypatch):
    """HELICON_NATIVE_REFINE=0: the reference's Python loop refines the
    top candidate (the unclipped start scored, an early exit, the last
    iterate unscored); linear interpolation, poses 1e-3, scores 1e-4. The
    reference runs jitted here (its eager loop costs minutes): linear
    samples do not jump where XLA fuses a multiply-add (ROADMAP C6). The
    fixed-pose scores of the jitted search are not held here (the eager
    tests hold them): the refined candidate's score is."""
    monkeypatch.setenv("HELICON_NATIVE_REFINE", "0")
    image, tw, ri, kw = _tiny(refine_tilt_psi_dy_range=RANGE, interpolation="linear")
    tw, ri = tw[3:6], ri[3:6]
    port = _port(image, tw, ri, **kw)
    ref = ref_reconstruct_grid(image, twists=tw, rises=ri, devices=jax.devices()[:1], **kw)
    _same_refined(port, ref, atol=1e-3)
    (k,) = ref.refined_params
    assert abs(float(port.scores[k]) - float(ref.scores[k])) <= 1e-4
