#!/usr/bin/env python3
"""Drive the PyTorch port's grid search once on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. It builds the port's kernels from the sources in the
checkout, then runs four phases and fails (non-zero exit) if any fails:

1. the card's name and power limit, the torch and CUDA versions, the
   kernel build time;
2. the grouped-solve kernel against its plain PyTorch version on the same
   CUDA tensors, one twist group at the amyloid class average's own pixel
   size (float32: scores within 1e-4, x within 1e-3 relative; bfloat16
   A_top: scores within 1e-3, x within 5e-3 relative), then phase 4's 179
   distinct twist groups in one bfloat16 call, with both times per call;
3. the 45-candidate amyloid golden search in float32 and bfloat16: the
   top candidate must be (2.0 deg, 4.75 A);
4. the amyloid search at 2 A/px on a 2,327-candidate grid with the
   best-volume re-solve: every score finite, the volume finite and of
   shape (l3, d3, d3), the kernel launched, and its groups shaped as
   phase 2's batch; wall time, candidates/s and peak device memory.

The last two lines of standard output are the card's name and power
limit, and {"ok": true, "device": {...}}; the line before them lists each
kernel with its launches in phase 4, its error against the plain version
and both times. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AMYLOID = ROOT / "tests" / "data" / "class_avg_amyloid.npy"
KERNEL_SOURCE = "helicon_tpu_torch/denovo3d/csrc/group_solve.cu"
KERNEL_REPLACES = "helicon_tpu/denovo3d/pallas_solver.py:754"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events around reps calls,
    after one warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _real_size_grid():
    """Phase 4's (twists, rises): 179 twists x 13 rises, left-handed."""
    from helicon_tpu_torch.denovo3d import build_candidate_grid

    return build_candidate_grid(0.5, 45.0, 0.25, 4.0, 5.0, 0.08, handedness="left")


def _amyloid_groups(device, cdt, twists):
    """Solve inputs of phase 4's twist groups for ``twists`` (one group
    each, G = len(twists)), built by the port on ``device`` as
    reconstruct_grid builds them: the amyloid at 2 A/px, tube 110 A, the
    grid's rises, default solver settings."""
    import numpy as np

    from helicon_tpu_torch.core.filters import down_scale
    from helicon_tpu_torch.denovo3d import grid as G
    from helicon_tpu_torch.denovo3d.geometry import (
        ReconstructionGeometry, estimate_copy_pair_counts, estimate_n_pair_ops,
        select_copies,
    )
    from helicon_tpu_torch.denovo3d.group_solve import GroupInputs, group_inputs
    from helicon_tpu_torch.denovo3d.pipeline import (
        _pixel_geometry, auto_sym_oversample, derive_task_geometry,
    )
    from helicon_tpu_torch.denovo3d.projector_grouped import (
        build_candidate_tensors_grouped, build_group_shared,
    )
    from helicon_tpu_torch.denovo3d.solver import SolveConfig

    tw_all, ri_all = _real_size_grid()
    img = np.load(AMYLOID).astype(np.float32)
    lo, hi = float(ri_all.min()), float(ri_all.max())
    g = derive_task_geometry(img.shape, 2.0, hi, (lo, hi), (0, 0), -1, 110.0, 0.0,
                             3.0 * hi, -1, -1)
    img = down_scale(img, g["target_apix2d"], 2.0).cpu().numpy()
    pg = _pixel_geometry(g, img.shape, hi)
    geom = ReconstructionGeometry(
        d2=pg["d2"], l2=pg["l2"], d3=pg["d3"], l3=pg["l3"], rmin=pg["d3_inner"] / 2,
        rmax=pg["d3"] // 2 - 1, scale2d_to_3d=pg["target_apix2d"] / pg["target_apix3d"],
    )
    rp_all = ri_all / pg["target_apix3d"]
    so = auto_sym_oversample(geom.l3, geom.d3, pg["d3_inner"])
    n_copies, n_pairs = estimate_copy_pair_counts(geom, float(rp_all.min()), so,
                                                  rise_pixel_max=float(rp_all.max()))
    n_ops = estimate_n_pair_ops(geom, float(rp_all.min()))
    u = set()
    for r in np.unique(rp_all):
        ch, cc, cv = select_copies(geom, float(r), n_copies)
        u.update(zip(ch[cv].tolist(), cc[cv].tolist()))
    hmax = (n_ops - 1) // 2
    ops_h = np.arange(-hmax, hmax + 1).astype(np.int32)
    ny, nx = img.shape
    region = img[ny // 2 - geom.d2 // 2 : ny // 2 + geom.d2 // 2,
                 nx // 2 - geom.l2 // 2 : nx // 2 + geom.l2 // 2]
    inp = None
    for gi, twist in enumerate(twists):
        rp = rp_all[tw_all == np.float32(twist)]
        rpad, m, ch_u, cc_u, pidx, pval, _ = G._group_tables(
            geom, float(twist), rp, n_copies, n_pairs, n_ops, len(u), len(rp), {}
        )
        shared = build_group_shared(geom, np.float32(twist), ch_u, cc_u, ops_h,
                                    np.zeros_like(ops_h), np.float32(0.0), "nn",
                                    geom.cylindrical_mask(), geom.cell_valid_mask(), cdt,
                                    device)
        tens = build_candidate_tensors_grouped(shared, geom, region, rpad, np.sqrt(m),
                                               pidx, pval)
        tens["lb"], tens["ub"] = G._box_bounds(
            G._positive(SolveConfig(), rpad, float(twist), geom.l3), tens["ub_raw"])
        one = group_inputs(shared, tens)
        if inp is None:
            inp = GroupInputs.empty(len(twists), one)
        inp.put(gi, one)
        del shared, tens, one
    return geom, len(u), inp


def phase_kernel_vs_plain(device) -> dict:
    """Phase 2: the kernel and its plain version on the same CUDA tensors:
    one group (twist 2.0 deg) in float32 and in bfloat16, then all 179
    distinct twist groups of phase 4 in one bfloat16 call (its G)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import group_solve as gs

    iters = (10, 16, 2)
    row = {}
    main_twists = np.unique(_real_size_grid()[0])
    # (name, dtype, score abs limit, x relative limit, twists)
    cases = (("float32", torch.float32, 1e-4, 1e-3, [2.0]),
             ("bfloat16", torch.bfloat16, 1e-3, 5e-3, [2.0]),
             ("bfloat16", torch.bfloat16, 1e-3, 5e-3, main_twists))
    for name, cdt, score_tol, x_tol, twists in cases:
        geom, C_u, inp = _amyloid_groups(device, cdt, twists)
        G = len(twists)
        x_k, s_k = gs.solve_group(inp, *iters)
        x_p, s_p = gs.solve_group_reference(inp, *iters)
        torch.cuda.synchronize()
        score_err = float((s_k - s_p).abs().max())
        x_rel = float((x_k - x_p).abs().max() / x_p.abs().max().clamp_min(1e-30))
        del x_k, x_p
        reps = 5 if G == 1 else 2
        ms_k = _time_ms(lambda: gs.solve_group(inp, *iters), reps)
        ms_p = _time_ms(lambda: gs.solve_group_reference(inp, *iters), reps)
        _, R, _, O, l3, d3sq = inp.shape
        print(f"phase 2 [{name}, G={G} distinct twist groups] d3={geom.d3} l3={l3} "
              f"C_u={C_u} O={O} R={R} A_top={tuple(inp.a_top.shape[1:])}: score abs err "
              f"{score_err:.3e} (limit {score_tol:g}), x rel err {x_rel:.3e} (limit "
              f"{x_tol:g}), kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms per call", flush=True)
        if not (score_err <= score_tol):
            raise AssertionError(f"{name} kernel scores differ from plain by {score_err}")
        if not (x_rel <= x_tol):
            raise AssertionError(f"{name} kernel x differs from plain by {x_rel} relative")
        row[(name, G)] = dict(max_abs_err=score_err, x_rel_err=x_rel, ms=ms_k, plain_ms=ms_p,
                              groups=(G, R, C_u, O))
        del inp
        torch.cuda.empty_cache()
    return row


def phase_golden(device) -> None:
    """Phase 3: the 45-candidate amyloid golden through reconstruct_grid."""
    import numpy as np

    from helicon_tpu_torch.denovo3d import build_candidate_grid, reconstruct_grid

    img = np.load(AMYLOID)
    tw, ri = build_candidate_grid(1.0, 3.0, 0.25, 4.45, 5.06, 0.15, handedness="left")
    for dtype in ("float32", "auto"):
        t0 = time.perf_counter()
        res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                               cg_iters=10, fista_iters=16, power_iters=2,
                               compute_dtype=dtype, return_best_volume=False, device=device)
        best_tw, best_ri, best_s = res.top(1)[0]
        print(f"phase 3 [{res.effective['compute_dtype']}] {len(tw)} candidates in "
              f"{time.perf_counter() - t0:.2f} s, top-1 ({best_tw}, {best_ri}) "
              f"score {best_s:.6f}", flush=True)
        if (float(best_tw), float(best_ri)) != (2.0, 4.75):
            raise AssertionError(f"golden top-1 is ({best_tw}, {best_ri}), not (2.0, 4.75)")


def phase_real_size(device) -> int:
    """Phase 4: the amyloid search at its own pixel size; returns the
    kernel launches of the run."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import group_solve, reconstruct_grid

    img = np.load(AMYLOID)
    tw, ri = _real_size_grid()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group_solve.launches = 0
    t0 = time.perf_counter()
    res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                           cg_iters=10, fista_iters=16, power_iters=2,
                           return_best_volume=True, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = group_solve.launches
    geom, eff = res.geom, res.effective
    print(f"phase 4: {len(tw)} candidates, {eff['n_groups']} groups of R={eff['R']}, "
          f"G={eff['groups_per_launch']} groups per launch, C_u={eff['C_u']}, "
          f"d2={geom.d2} l2={geom.l2} d3={geom.d3} l3={geom.l3}, {eff['compute_dtype']}: "
          f"{wall:.3f} s wall incl. best volume, {len(tw) / wall:.1f} candidates/s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{launches} kernel launches; operator build {eff['build_s']:.3f} s, solve "
          f"{eff['solve_s']:.3f} s; top-1 {tuple(float(v) for v in res.top(1)[0])}", flush=True)
    if launches <= 0:
        raise AssertionError("the search did not launch the group-solve kernel")
    if not np.all(np.isfinite(res.scores)):
        raise AssertionError("non-finite scores")
    bv = res.best_volume
    if bv is None or bv.shape != (geom.l3, geom.d3, geom.d3) or not np.all(np.isfinite(bv)):
        raise AssertionError("best volume missing, misshapen or non-finite")
    return launches, (eff["n_groups"], eff["R"], eff["C_u"], eff["n_ops"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "helicon_tpu_torch").is_dir() or not AMYLOID.exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from helicon_tpu_torch import _build

    device = torch.device("cuda", 0)
    card = _card_line()
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cmp = phase_kernel_vs_plain(device)
    phase_golden(device)
    launches, groups = phase_real_size(device)
    k = cmp[("bfloat16", 179)]
    if k["groups"] != groups:
        raise AssertionError(f"phase 2 solved groups {k['groups']}, phase 4 {groups} "
                             "(n_groups, R, C_u, n_ops)")
    print(json.dumps({"kernels": [{
        "name": "group_solve", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
