"""The port's flat namespace (``import helicon_tpu_torch as ht``) against
the JAX package's: every public name but the stated TPU-only ones, the
module-level cache directory, the device rule of every exported array
function (a tensor keeps its device; numpy goes to the keyword ``device``,
"cuda" by default), a handful of namespace functions on numpy equal to the
reference's, the copies of utils/system.py, utils/logging.py and
io/mrc.display_map_orthoslices pinned to the originals, and a cold import
that pulls in no JAX, no scikit-learn and no kernel build."""

import inspect
import io
import json
import logging
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

torch.set_num_threads(1)

import helicon_tpu as ref
import helicon_tpu_torch as ht
from test_namespace import REFERENCE_EXPORTS

ROOT = Path(__file__).resolve().parents[1]

# the TPU's compilation cache and matmul DFT (ROADMAP "Do not port")
DO_NOT_PORT = {"enable_jax_compilation_cache", "fft"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def _reference_public_names():
    """The reference's public names after a cold import (other tests of a
    worker import more of its submodules into its namespace)."""
    code = ("import json, jax; jax.config.update('jax_platforms', 'cpu'); "
            "import helicon_tpu as h; print(json.dumps(sorted(n for n in dir(h) "
            "if not n.startswith('_'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_reference_name_exists():
    missing = sorted(n for n in REFERENCE_EXPORTS if not hasattr(ht, n))
    assert missing == []
    names = _reference_public_names()
    assert len(names) >= 269
    missing = sorted(names - _public(ht) - DO_NOT_PORT)
    assert missing == []
    assert not DO_NOT_PORT & _public(ht)
    for name in ("io", "helix", "denovo3d", "ops", "commands", "parallel", "apps", "webApps",
                 "dataset"):
        assert isinstance(getattr(ht, name), types.ModuleType), name
    assert ht.EMDB is ht.dataset.EMDB
    with pytest.raises(AttributeError):
        ht.no_such_name


def test_version_and_cache_dir():
    assert ht.__version__ == ref.__version__
    assert ht.cache_dir.exists() and ht.cache_dir == ht.setup_cache_dir()


def _exported_callables():
    out = {}
    for name in sorted(_public(ht)):
        obj = getattr(ht, name)
        if isinstance(obj, types.ModuleType) or not callable(obj):
            continue
        try:
            out[name] = inspect.signature(obj)
        except (TypeError, ValueError):
            continue
    return out


def test_every_device_parameter_defaults_to_cuda():
    """Every exported callable with a device parameter defaults it to
    "cuda", and the array functions of core/ and helix/ all have one."""
    sigs = _exported_callables()
    with_device = {n for n, s in sigs.items() if "device" in s.parameters}
    wrong = {n: sigs[n].parameters["device"].default for n in with_device
             if sigs[n].parameters["device"].default != "cuda"}
    assert wrong == {}
    for name in ("apply_helical_symmetry", "calc_fsc", "low_high_pass_filter", "transform_map",
                 "map_coordinates", "ctf_2d", "czt", "denoise_image", "euler_matrix",
                 "compute_power_spectra", "curvelet_denoise_mct", "phase_cross_correlation",
                 "simulate_helical_projection", "generate_xyz_projections", "cosine_similarity",
                 "AgglomerativeClusteringWithMinSize", "assign_beamshifts_to_cluster",
                 "batched_cross_correlation", "detect_layer_lines", "generate_tapering_filter"):
        assert name in with_device, name
    assert len(with_device) >= 70, len(with_device)


def test_numpy_goes_to_the_card_and_a_tensor_stays():
    """Numpy without ``device`` is taken to the card (which this CPU-only
    build cannot reach: it raises); a CPU tensor stays on the CPU."""
    img = np.random.default_rng(0).random((16, 16)).astype(np.float32)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            ht.low_high_pass_filter(img, low_pass_fraction=0.5)
    out = ht.low_high_pass_filter(torch.as_tensor(img), low_pass_fraction=0.5)
    assert out.device.type == "cpu"
    assert ht.normalize_min_max(img, device="cpu").device.type == "cpu"


class _HostOps(TorchDispatchMode):
    """Records every operation that reads or makes a host tensor (other
    than the wrap of a numpy array and the copy of one to a device), and
    counts the operations on the meta device."""

    WRAP = {"aten::lift_fresh", "aten::lift_fresh_copy", "aten::detach", "aten::alias"}
    COPY = WRAP | {"aten::_to_copy", "aten::copy_"}

    def __init__(self):
        super().__init__()
        self.host, self.meta = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        ins = [t for t in tree_leaves((args, kwargs or {})) if isinstance(t, torch.Tensor)]
        self.meta += any(t.device.type == "meta" for t in ins)
        if name not in self.COPY and any(t.device.type == "cpu" and t.dim() for t in ins):
            self.host.append(name)
        out = func(*args, **(kwargs or {}))
        if name not in self.WRAP and any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                                         and t.dim() for t in tree_leaves(out)):
            self.host.append(f"{name} (made)")
        return out


_IMG = np.random.default_rng(3).random((32, 32), dtype=np.float32)
_IMG2 = np.roll(_IMG, (2, -3), axis=(0, 1))
_VOL = np.random.default_rng(4).random((16, 16, 16), dtype=np.float32)
_VOL2 = _VOL + 0.3 * np.random.default_rng(5).random((16, 16, 16), dtype=np.float32)
_GRID2 = np.indices((32, 32)).astype(np.float32) + 0.5
_GRID3 = np.indices((16, 16, 16)).astype(np.float32) + 0.5

# the exported functions that take more than one array
MULTI_ARRAY_CALLS = dict(
    calc_fsc=lambda d: ht.calc_fsc(_VOL, _VOL2, 1.0, device=d),
    calc_fsc_from_fft=lambda d: ht.calc_fsc_from_fft(np.fft.rfftn(_VOL), np.fft.rfftn(_VOL2),
                                                     16, 1.0, device=d),
    calc_fsc_per_shell=lambda d: ht.calc_fsc_per_shell(_VOL, _VOL2, 1.0, device=d),
    calc_frc_2d=lambda d: ht.calc_frc_2d(_IMG, _IMG2, 1.0, device=d),
    frc_score=lambda d: ht.frc_score(_IMG, _IMG2, 1.0, device=d),
    cross_correlation_map=lambda d: ht.cross_correlation_map(_IMG, _IMG2, device=d),
    batched_cross_correlation=lambda d: ht.batched_cross_correlation(_IMG[None], _IMG2[None],
                                                                     device=d),
    cosine_similarity=lambda d: ht.cosine_similarity(_IMG.ravel(), _IMG2.ravel(), device=d),
    cross_correlation_coefficient=lambda d: ht.cross_correlation_coefficient(_IMG, _IMG2,
                                                                             device=d),
    ssim_score=lambda d: ht.ssim_score(_IMG, _IMG2, device=d),
    ssim_score_traced=lambda d: ht.ssim_score_traced(_IMG, _IMG2, device=d),
    ms_ssim_score=lambda d: ht.ms_ssim_score(_IMG, _IMG2, device=d),
    ms_ssim_score_traced=lambda d: ht.ms_ssim_score_traced(_IMG, _IMG2, device=d),
    mutual_information_score=lambda d: ht.mutual_information_score(_IMG, _IMG2, device=d),
    mutual_information_score_traced=lambda d: ht.mutual_information_score_traced(_IMG, _IMG2,
                                                                                 device=d),
    r_factor_score=lambda d: ht.r_factor_score(_IMG, _IMG2, device=d),
    phase_cross_correlation=lambda d: ht.phase_cross_correlation(_IMG, _IMG2, device=d),
    align_images=lambda d: ht.align_images(_IMG2, _IMG, 0.0, 0.0, device=d),
    match_structural_factors=lambda d: ht.match_structural_factors(_VOL, 1.0, _VOL2, 1.0,
                                                                   device=d),
    map_coordinates=lambda d: ht.map_coordinates(_IMG, _GRID2, order=1, device=d),
    linear_gather_2d=lambda d: ht.linear_gather_2d(_IMG, *_GRID2, device=d),
    trilinear_gather_3d=lambda d: ht.trilinear_gather_3d(_VOL, *_GRID3, device=d),
    line_fit_projection=lambda d: ht.line_fit_projection(np.arange(9.0), 2 * np.arange(9.0) + 1,
                                                         device=d),
)


@pytest.mark.parametrize("name", sorted(MULTI_ARRAY_CALLS))
def test_every_numpy_argument_goes_to_device(name):
    """All the numpy arguments of a function that takes several go to its
    ``device``, none to the host: on the meta device (this build's other
    device) every operation up to the first read back to the host (which
    meta tensors cannot give) runs on meta and none reads or makes a host
    array tensor."""
    rec = _HostOps()
    try:
        with rec:
            MULTI_ARRAY_CALLS[name]("meta")
    except (NotImplementedError, RuntimeError) as e:
        assert "meta" in str(e) and "expected device" not in str(e), e
    assert rec.meta > 0
    assert rec.host == []


def _blob(shape, seed=0):
    g = np.random.default_rng(seed)
    grids = np.meshgrid(*(np.arange(n) - n / 2 for n in shape), indexing="ij")
    v = np.exp(-sum(x * x for x in grids) / 10.0)
    return (v + 0.05 * g.normal(size=shape)).astype(np.float32)


CALLS = dict(
    low_high_pass_filter=(lambda m: m.low_high_pass_filter(
        _blob((24, 20)), low_pass_fraction=0.4, high_pass_fraction=0.05), 1e-5),
    normalize_percentile=(lambda m: m.normalize_percentile(_blob((12, 14))), 1e-6),
    calc_fsc=(lambda m: m.calc_fsc(_blob((16, 16, 16), 1), _blob((16, 16, 16), 2), 1.5), 1e-5),
    crop_pad=(lambda m: m.pad_to_size(_blob((10, 12)), (16, 16)), 0.0),
    transform_image=(lambda m: m.transform_image(_blob((20, 20)), rotation=17.0), 1e-5),
    # 3 float32 ulps of the corner's phase, as tests/test_torch_indexing.py
    ctf_2d=(lambda m: m.ctf_2d((32, 32), 1.2, defocus_u_A=15000.0, defocus_v_A=14000.0,
                              astig_angle_deg=30.0),
            3 * float(np.spacing(np.float32(np.pi * ref.electron_wavelength(300.0)
                                            * 2 * (0.5 / 1.2) ** 2 * 15000.0)))),
    euler_matrix=(lambda m: m.euler_matrix("ZYZ", [10.0, 20.0, 30.0]), 1e-6),
    cosine_similarity=(lambda m: m.cosine_similarity(_blob((30,)), _blob((30,), 1)), 1e-6),
    flip_hand=(lambda m: m.flip_hand(_blob((6, 7, 8)), axis="y"), 0.0),
)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_namespace_functions_match_reference(name, monkeypatch):
    """Namespace functions on the same numpy input, the port's with
    device="cpu" (bound here for each call), equal the reference's."""
    fn, tol = CALLS[name]
    want = np.asarray(fn(ref), np.float64)

    class _OnCPU:
        def __getattr__(self, attr):
            f = getattr(ht, attr)
            if "device" in inspect.signature(f).parameters:
                return lambda *a, **k: f(*a, device="cpu", **k)
            return f

    got = fn(_OnCPU())
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


# --------------------------------------------------------------------------
# the host copies pinned to their originals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(0,), (999,), (1024,), (5 * 1024**3,), (3e15,), (2048, "k"),
                                  (10**6, "m", 1000)])
def test_bytes2units_matches(args):
    assert ht.bytes2units(*args) == ref.bytes2units(*args)


def test_system_helpers_match():
    for n in (0, 0.5, 1, 7, 10, 11, 12345):
        assert ht.ceil_power_of_10(n) == ref.ceil_power_of_10(n)
    for f in ("has_shiny", "has_streamlit", "has_curvelet_fdct", "has_curvelet_udct",
              "get_terminal_size", "omp_get_max_threads"):
        assert getattr(ht, f)() == getattr(ref, f)(), f
    assert ht.available_cpu() >= 1 and ht.available_cpu(mem_gb_per_cpu=1e6) >= 1
    assert ht.available_devices() == torch.cuda.device_count()
    assert ht.has_curvelet_udct_gpu() == torch.cuda.is_available()
    ht.omp_set_num_threads(ht.omp_get_max_threads())

    def caller():
        return ht.get_context_function_name(), ref.get_context_function_name()

    assert caller() == ("caller", "caller")
    assert ht.import_with_auto_install("math") is ref.import_with_auto_install("math")
    with pytest.raises(ImportError, match="no_such_pkg"):
        ht.import_with_auto_install("no_such_pkg_x", pip_name="no_such_pkg")
    img = (np.arange(64, dtype=np.float32).reshape(8, 8)) ** 1.5
    for kw in (dict(), dict(hflip=True), dict(vflip=True)):
        assert ht.encode_numpy(img, **kw) == ref.encode_numpy(img, **kw)
    assert ht.encode_numpy(np.zeros((4, 4), np.float32)) == ref.encode_numpy(
        np.zeros((4, 4), np.float32))
    from PIL import Image

    pil = Image.fromarray(np.arange(256, dtype=np.uint8).reshape(16, 16))
    assert ht.encode_PIL_Image(pil, hflip=True) == ref.encode_PIL_Image(pil, hflip=True)


def test_logging_helpers_match(tmp_path):
    for pkg in (ht, ref):
        buf = io.StringIO()
        with redirect_stdout(buf):
            pkg.color_print("hello", 3, color="green")
        assert buf.getvalue() == "hello 3\n"
    for verbose in (0, 1, 2):
        a = ht.getLogger(str(tmp_path / "a.log"), verbose=verbose, name="port_logger")
        b = ref.getLogger(str(tmp_path / "b.log"), verbose=verbose, name="ref_logger")
        assert [type(h) for h in a.handlers] == [type(h) for h in b.handlers]
        assert [h.level for h in a.handlers] == [h.level for h in b.handlers]
        a.info("x")
        for h in a.handlers + b.handlers:
            h.close()
    assert (tmp_path / "a.log").read_text().endswith("INFO port_logger: x\n")
    logging.getLogger("port_logger").handlers.clear()
    logging.getLogger("ref_logger").handlers.clear()


def test_display_map_orthoslices_matches():
    pytest.importorskip("matplotlib")
    vol = _blob((6, 8, 10))
    figs = [pkg.display_map_orthoslices(v, title="m", show=False)
            for pkg, v in ((ht, torch.as_tensor(vol)), (ref, vol))]
    for a, b in zip(*(f.axes for f in figs)):
        assert a.get_title() == b.get_title()
        np.testing.assert_array_equal(a.images[0].get_array(), b.images[0].get_array())
    import matplotlib.pyplot as plt

    for f in figs:
        plt.close(f)


def test_cold_import_pulls_in_no_jax_sklearn_or_kernel_build():
    """The import binds cache_dir and loads the namespace only at the first
    access of one of its names (a command imports its own modules and does
    not pay for the rest); neither pulls in JAX, scikit-learn or a kernel
    build."""
    code = ("import sys, helicon_tpu_torch as ht\n"
            "assert ht.cache_dir.exists()\n"
            "assert 'helicon_tpu_torch._namespace' not in sys.modules\n"
            "assert 'pandas' not in sys.modules\n"
            "ht.AgglomerativeClusteringWithMinSize\n"
            "assert 'helicon_tpu_torch._namespace' in sys.modules\n"
            "bad = [m for m in ('jax', 'sklearn', 'helicon_tpu', 'helicon', "
            "'torch.utils.cpp_extension') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


def test_former_cpu_defaults_now_take_the_card():
    """gather_kernels.rotations and curvelet_bands_2d / _3d took the CPU by
    default; now "cuda", as every entry point: without a device they reach
    for the card (which this CPU-only build cannot), with device="cpu" they
    run on the CPU."""
    from helicon_tpu_torch.core import curvelet
    from helicon_tpu_torch.denovo3d import gather_kernels

    calls = ((gather_kernels.rotations, ([3.0], [1.0])),
             (curvelet.curvelet_bands_2d, ((16, 16),)),
             (curvelet.curvelet_bands_3d, ((8, 8, 8),)))
    for fn, args in calls:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
        out = fn(*args, device="cpu")
        out = out[0] if isinstance(out, tuple) else out
        assert out.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                fn(*args)
