"""The web app's single task in the PyTorch port against the JAX package:
lsq_reconstruct (the inputs of tests/test_denovo3d.py's lsq_reconstruct
cases) and process_one_task (the 48 x 96 px helix image of
tests/test_denovo3d_pipeline.py), on the CPU.

Both packages solve at the bench's iteration budget (cg 10, fista 16,
power 2: SolveConfig's defaults patched in both), where the two float32
solves agree to ~1e-6; at the default budget (120 / 120) CG runs far past
convergence and amplifies rounding, so that the reference's own jitted and
eager volumes differ by 4.9e-4 relative there
(test_default_budget_scores_match_reference holds the scores at 1e-4 and
the volume at 5e-3).

The helix has twist 30 deg, where sin is 1/2 and samples sit on voxel
edges. Inside process_one_task the reference's lsq_reconstruct runs eagerly
(jax.disable_jit()): jitted, XLA's fused z arithmetic moves half-way
nearest-neighbour samples there (ROADMAP C6) and the volume by 2.9e-2.
The refined task solves off tilt 0, where the two agree to 1e-6 jitted:
it runs the reference jitted (eagerly it takes twice as long).
The cases marked xla_cos_sin take XLA's float32 cos / sin at the port's
two evaluation points (projector_separable.cos_sin, core.rotation.cos_sin):
the last bit decides the voxel of a sample on an edge (ROADMAP C11), and
PyTorch's moves those cases' scores by up to 1.1e-3.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from helicon_tpu.denovo3d import pipeline as ref_pipeline
from helicon_tpu.denovo3d import solver as ref_solver
from helicon_tpu.helix import simulate_helical_projection as ref_simulate
from helicon_tpu.utils.exceptions import HeliconError as RefHeliconError
from helicon_tpu_torch.core import rotation as port_rotation
from helicon_tpu_torch.denovo3d import lsq_reconstruct, pipeline, process_one_task, solver
from helicon_tpu_torch.denovo3d import projector_separable as port_ps
from helicon_tpu_torch.utils.exceptions import HeliconError

BUDGET = dict(cg_iters=10, fista_iters=16, power_iters=2)


def _set_budget(monkeypatch, **iters):
    for cls in (ref_solver.SolveConfig, solver.SolveConfig):
        names = list(cls._fields)
        defaults = list(cls.__new__.__defaults__)
        for k, v in iters.items():
            defaults[names.index(k)] = v
        monkeypatch.setattr(cls.__new__, "__defaults__", tuple(defaults))


def _jax_cos_sin(theta):
    """XLA's float32 cos and sin of the port's angles (ROADMAP C11)."""
    t = jnp.asarray(theta.detach().cpu().numpy())
    return (torch.from_numpy(np.array(jnp.cos(t))).to(theta.device),
            torch.from_numpy(np.array(jnp.sin(t))).to(theta.device))


@pytest.fixture(autouse=True)
def bench_budget(monkeypatch, tmp_path_factory):
    """The bench's iteration budget in both packages, and the reference's
    native refine engine built under the test's temporary directory."""
    _set_budget(monkeypatch, **BUDGET)
    monkeypatch.setenv("HELICON_NATIVE_CACHE", str(tmp_path_factory.getbasetemp() / "native"))


def _eager(fn):
    def run(*args, **kw):
        with jax.disable_jit():
            return fn(*args, **kw)
    return run


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sim(ny, nx, csym=1, rng=0):
    return np.squeeze(np.asarray(ref_simulate(
        n=1, twist=30.0, rise=6.0, csym=csym, helical_diameter=40.0, ball_radius=5.0,
        polymer=0, planarity=1.0, ny=ny, nx=nx, apix=2.0, rng=rng), np.float32)).copy()


LSQ_KW = dict(scale2d_to_3d=1.0, reconstruct_diameter_2d_pixel=24,
              reconstruct_diameter_3d_pixel=24, reconstruct_length_2d_pixel=48,
              reconstruct_length_3d_pixel=16, sym_oversample=2, interpolation="nn",
              twist_degree=30.0, rise_pixel=3.0, csym=1)
# tests/test_denovo3d.py's cases (:213-250, :519-560, :782-810)
LSQ_CASES = dict(
    nn=dict(),
    linear=dict(interpolation="linear"),
    csym2=dict(csym=2, image=dict(csym=2, rng=1)),
    inner_diameter=dict(reconstruct_diameter_3d_inner_pixel=8),
    tilt_psi=dict(tilt_degree=3.0, psi_degree=1.0),
    fsc2=dict(fsc_test=2),
    wrong_candidate=dict(twist_degree=55.0, rise_pixel=2.0),
    odd_region=dict(reconstruct_diameter_2d_pixel=23, reconstruct_diameter_3d_pixel=23,
                    reconstruct_length_2d_pixel=47, reconstruct_length_3d_pixel=15,
                    xla_cos_sin=True),
    elasticnet_ssim=dict(algorithm=dict(model="elasticnet"), score_metric="ssim"),
)


def _both(kw):
    kw = dict(LSQ_KW, **kw)
    img = _sim(32, 64, **kw.pop("image", {}))
    (r, h1, h2), s = lsq_reconstruct(img, device="cpu", **kw)
    (R, H1, H2), S = ref_solver.lsq_reconstruct(img, **kw)
    return (r, h1, h2), s, (R, H1, H2), S


@pytest.mark.parametrize("name", sorted(LSQ_CASES))
def test_lsq_reconstruct_matches_reference(name, monkeypatch):
    kw = dict(LSQ_CASES[name])
    if kw.pop("xla_cos_sin", False):
        monkeypatch.setattr(port_ps, "cos_sin", _jax_cos_sin)
    (r, h1, h2), s, (R, H1, H2), S = _both(kw)
    assert abs(s - S) < 1e-4, (s, S)
    assert r.device.type == "cpu" and tuple(r.shape) == R.shape
    assert _rel(r, R) < 1e-4
    if H1 is None:
        assert h1 is None and h2 is None
    else:
        assert _rel(h1, H1) < 1e-4 and _rel(h2, H2) < 1e-4
    if name == "inner_diameter":
        nz, ny, nx = r.shape
        assert float(r[:, ny // 2 - 1 : ny // 2 + 2, nx // 2 - 1 : nx // 2 + 2].abs().max()) == 0.0


def test_default_budget_scores_match_reference(monkeypatch):
    _set_budget(monkeypatch, cg_iters=120, fista_iters=120, power_iters=8)
    (r, _, _), s, (R, _, _), S = _both({})
    assert abs(s - S) < 1e-4, (s, S)
    assert _rel(r, R) < 5e-3


def test_lsq_reconstruct_region_too_large_raises():
    img = _sim(32, 64)
    kw = dict(LSQ_KW, reconstruct_diameter_2d_pixel=64)
    with pytest.raises(HeliconError):
        lsq_reconstruct(img, device="cpu", **kw)
    with pytest.raises(RefHeliconError):
        ref_solver.lsq_reconstruct(img, **kw)


@pytest.mark.parametrize("model", ["lreg", "lsq"])
def test_refinement_and_refined_params_channel(model):
    """tests/test_denovo3d_pipeline.py's channel case (lreg: the loop
    semantics) and the default model (the engine's fixed semantics): the
    same refined pose and score; the pose leaves through both channels and
    an unrefined call clears them."""
    img = _sim(48, 96)[:32, :48]
    kw = dict(scale2d_to_3d=0.5, twist_degree=30.0, rise_pixel=1.5, csym=1, sym_oversample=1,
              interpolation="nn", algorithm=dict(model=model),
              refine_tilt_psi_dy_range=dict(tilt=2.0, psi=0.0, dy=0.0, max_iter=2))
    (r, _, _), s = lsq_reconstruct(img, device="cpu", **kw)
    (R, _, _), S = ref_solver.lsq_reconstruct(img, **kw)
    refined, want = solver.consume_refined_params(), ref_solver.consume_refined_params()
    assert set(refined) == {"tilt", "psi", "dy"} and refined == lsq_reconstruct._refined_params
    np.testing.assert_allclose([refined[k] for k in "tilt psi dy".split()],
                               [want[k] for k in "tilt psi dy".split()], atol=5e-3)
    assert abs(s - S) < 1e-4 and _rel(r, R) < 1e-4
    assert solver.consume_refined_params() == {}
    kw.pop("refine_tilt_psi_dy_range")
    lsq_reconstruct(img, device="cpu", **kw)
    assert solver.consume_refined_params() == {} and lsq_reconstruct._refined_params == {}


def make_task(data, twist=30.0, rise=6.0, **overrides):
    """tests/test_denovo3d_pipeline.py's task."""
    task = dict(
        ti=0, ntasks=1, data=data, imageFile="synthetic.mrcs", imageIndex=1,
        twist=twist, rise=rise, rise_range=(rise, rise), csym=1,
        tilt=0, tilt_range=(0, 0), psi=0, psi_range=0, dy=0, dy_range=0,
        apix2d_orig=2.0, denoise="", low_pass=-1, transpose=0,
        horizontalize=0, target_apix3d=2.0, target_apix2d=2.0,
        thresh_fraction=-1, positive_constraint=-1, tube_length=-1,
        tube_diameter=44.0, tube_diameter_inner=0, reconstruct_length=20.0,
        sym_oversample=2, interpolation="nn", fsc_test=0, return_3d=True,
        score_metric="cosine", algorithm=dict(model="lsq"), verbose=0,
    )
    task.update(overrides)
    return task


@pytest.fixture(scope="module")
def helix_image():
    return _sim(48, 96)


TASK_CASES = dict(
    auto_geometry=dict(tube_diameter=-1, reconstruct_length=-1, sym_oversample=-1,
                       target_apix3d=-1, xla_cos_sin=True),
    fsc=dict(fsc_test=1),
    thresh=dict(thresh_fraction=0.2),
    denoise_horizontalize=dict(denoise="tv", horizontalize=1, noise=0.3),
    csym_no_3d=dict(csym=2, return_3d=False, xla_cos_sin=True),
    refine_tilt=dict(tilt=1.0, tilt_range=(-2.0, 2.0), dy_range=1.0, jit_ref=True),
)


def _hold_task(got, want):
    """process_one_task's outputs against the reference's: the score 1e-4,
    the display images and volumes 1e-4 relative, the sizes and metadata
    equal (the metadata image 1e-5 relative)."""
    (s, data, meta), (S, DATA, META) = got, want
    assert abs(s - S) < 1e-4, (s, S)
    for g, w in zip(data[:3], DATA[:3]):  # x / y projections, z sections
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        assert _rel(g, w) < 1e-4
    if DATA[3] is None:
        assert data[3] is None
    else:
        for g, w in zip(data[3], DATA[3]):
            assert (g is None) == (w is None)
            if w is not None:
                assert _rel(g, w) < 1e-4
    assert data[4:] == DATA[4:]
    assert _rel(meta[0], META[0]) < 1e-5
    assert meta[1:] == META[1:]


@pytest.fixture
def eager_ref_solve(monkeypatch):
    monkeypatch.setattr(ref_pipeline, "lsq_reconstruct", _eager(ref_solver.lsq_reconstruct))


@pytest.mark.parametrize("name", sorted(TASK_CASES))
def test_process_one_task_matches_reference(helix_image, name, eager_ref_solve, monkeypatch):
    kw = dict(TASK_CASES[name])
    if kw.pop("xla_cos_sin", False):
        monkeypatch.setattr(port_ps, "cos_sin", _jax_cos_sin)
        monkeypatch.setattr(port_rotation, "cos_sin", _jax_cos_sin)
    if kw.pop("jit_ref", False):
        monkeypatch.setattr(ref_pipeline, "lsq_reconstruct", ref_solver.lsq_reconstruct)
    img = helix_image
    noise = kw.pop("noise", 0)
    if noise:
        img = img + noise * np.random.default_rng(0).standard_normal(img.shape).astype(np.float32)
    got = process_one_task(**make_task(img, **kw), device="cpu")
    _hold_task(got, ref_pipeline.process_one_task(**make_task(img, **kw)))
    meta = got[2]
    if name == "thresh":
        # the metadata image is the background-subtracted one
        ny = meta[0].shape[0]
        assert min(abs(float(np.median(meta[0][[ny // 2 - nr, ny // 2 + nr]])))
                   for nr in range(1, ny // 2 - 1)) < 1e-6


def test_process_one_task_blank_and_file(tmp_path, helix_image, eager_ref_solve):
    """A blank image gives None; the default task, its image read from an
    MRC stack, matches the reference."""
    blank = np.zeros((48, 96), np.float32)
    assert process_one_task(**make_task(blank), device="cpu") is None
    assert ref_pipeline.process_one_task(**make_task(blank)) is None
    from helicon_tpu_torch.io.mrc import write_mrc

    write_mrc(tmp_path / "in.mrcs", np.stack([blank, helix_image]), apix=2.0)
    task = make_task(None, imageFile=str(tmp_path / "in.mrcs"), imageIndex=2)
    _hold_task(process_one_task(**task, device="cpu"), ref_pipeline.process_one_task(**task))


def test_process_one_task_times(helix_image, monkeypatch):
    """The parts that a caller times by wrapping them (chip_smoke.py's
    phase 12): process_one_task reaches lsq_reconstruct's setup,
    apply_helical_symmetry and transform_map through their modules, once
    each, and transform_map gets the refined pose."""
    from helicon_tpu_torch.core import transforms

    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def run(*args, **kw):
            calls.setdefault(name, []).append(kw)
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, run)

    for module, name in ((solver, "_one_candidate"), (transforms, "apply_helical_symmetry"),
                         (transforms, "transform_map")):
        spy(module, name)
    process_one_task(**make_task(helix_image, tilt_range=(-1.0, 1.0)), device="cpu")
    assert {k: len(v) for k, v in calls.items()} == {
        "_one_candidate": 1, "apply_helical_symmetry": 1, "transform_map": 1}
    pose = solver.lsq_reconstruct._refined_params
    assert set(pose) == {"tilt", "psi", "dy"}
    assert calls["transform_map"][0]["tilt"] == pose["tilt"]
    assert pipeline.__all__.count("process_one_task") == 1
