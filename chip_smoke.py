#!/usr/bin/env python3
"""Drive the PyTorch port's grid search and kernels once on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. It builds the port's kernels from the sources in the
checkout, then runs ten phases and fails (non-zero exit) if any fails:

1. the card's name and power limit, the torch and CUDA versions, the
   kernel build time;
2. the grouped-solve kernel (B1) against its plain PyTorch version on the
   same CUDA tensors, one twist group at the amyloid class average's own
   pixel size (float32: scores within 1e-4, x within 1e-3 relative;
   bfloat16 A_top: scores within 1e-3, x within 5e-3 relative), then phase
   4's 179 distinct twist groups in one bfloat16 call, with both times per
   call, and each product alone (ms, and TB/s of A_top) beside cuBLAS's
   bmm for the same product: float32 at one group, bfloat16 at 179;
3. the 45-candidate amyloid golden search in float32 and bfloat16: the
   top candidate must be (2.0 deg, 4.75 A);
4. the amyloid search at 2 A/px on a 2,327-candidate grid with the
   best-volume re-solve: every score finite, the volume finite and of
   shape (l3, d3, d3), the kernel launched, and its groups shaped as
   phase 2's batch; wall time, candidates/s and peak device memory;
5. the single-candidate kernels: validate_on_gpu() at its tiny geometry,
   then B2 (solve_candidate, l2 = 0.01, l1 = 0.001, on nearest-neighbour
   and on linear factors) and B3 (score_candidate) on the top 8
   candidates of phase 4 at full width, each against its plain version in
   float32 (score within 1e-4, x within 1e-3 relative) and bfloat16 (1e-3,
   5e-3), B3's built W2 and Mxy bit-identical to the plain build, and B3's
   float32 scores within 1e-4 of solver.solve_candidate's (B2's float32
   route); for B2 (nn)
   the device time of each launch group summed over one solve (CUDA
   events: first product, glue_data, sym_fold, second product,
   reduce_l2_mask, vector updates), and in float32 each product alone
   beside cuBLAS's bmm;
6. the phase-4 search with linear interpolation (finite scores, B1
   launched, wall time and candidates/s), then the 45-candidate golden in
   linear: in float32 its top candidate must be the JAX package's linear
   top-1, (2.0 deg, 4.75 A); in bfloat16 every score must lie within 5e-3
   of float32's and its top-1 within 3e-4 of the float32 best;
7. the grouped solver envelope: validate_grouped_on_gpu() (eight
   configurations, kernel route against plain route under 5e-3); B1's
   options against its plain version on one amyloid group in float32 and
   bf16 (phase 2's gates): l1 + l2 columns without the score, and an fsc
   half-set's j-dependent z-Gram; the time per call at G = 179 in bf16 of
   the lsq solve beside the solve with an l2 column, with l1 + l2, and an
   fsc half-set solve; then phase 4's search under ridge, lasso,
   elasticnet, lreg, thresh_fraction 0.1, the four other score metrics
   and fsc mode 2 (wall, candidates/s, build / solve / score seconds,
   retry rounds, B1 launches, peak memory, top-1; every score and the
   best volume finite, B1 launched), each beside its 45-candidate golden
   in float32 and bf16 (every bf16 score within 5e-3 of float32's); and a
   report for ROADMAP C10: float32 searches of phase 4, phase 6 and the
   elasticnet and ssim searches beside their bf16 runs (top-10 overlap,
   Spearman, largest delta against the reference's bf16 contract);
8. the search drivers and the prep: (a) phase 4's twists over rises 2-10
   A (5,907 candidates, four rise buckets on B1, 593 re-scored at
   per-candidate geometry on the per-candidate path, B2, the winner's
   volume), each pass's times and B1 and B2 launches and each bucket's
   geometry, then the same search with the CLI's prep defaults
   (transpose -1, horizontalize 1: the prep's seconds by pass); (b) B1
   at R = 1, the route HELICON_GRID_GROUPED=1 forces on (a)'s largest
   second-pass call, against its plain version (scores within 1e-3),
   timed beside its bound; (c) phase 4's search as the web app calls it,
   with progress_callback and should_abort and no batch_size (launches of
   the reference's automatic batch), then aborted after its first launch;
   (d) (a)'s grid checkpointed in chunks of
   1,024, stopped after two and resumed (scores within 1e-3 of (a)'s, the
   same winner); (e) prepare_data (transpose -1, horizontalize 1,
   low_pass 10) and the denoisers on the card against the CPU, and the
   golden grid on a transposed, rotated amyloid with the CLI's prep
   defaults; (f) phase 4's search with fsc_test=1 (three B1 solves a
   launch);
9. the per-candidate path: (a) the largest second-pass call of 8 (a)
   with B2 against its plain version (bfloat16 scores within 1e-3, and
   the call in float32 within 1e-4), one of its B2 launches timed beside
   its bound; (b) the golden grid at tilt 3 deg on the gather projector
   (wall, candidates/s, peak memory, finite scores), the gather P and PT
   per application, and four golden candidates at tilt 0 on the gather
   projector against the separable path (float32 scores within 1e-4);
   (c) ard on the golden grid (B2's matvec entry under the EM loop) with
   the entry and with its plain version on the same card tensors
   (bfloat16 scores within 1e-3, float32 within 1e-4), one of the
   search's matvecs timed with both beside its bound, and the entry
   against plain on phase 5's float32 inputs (relative 1e-5); (d)
   elasticnet with fsc_test=2 on the golden grid with B2 and with its
   plain version (the halves on j-dependent z-Grams; the same gates),
   one of the search's half solves timed beside its bound, and B2 on an
   fsc half's j-dependent z-Gram against plain on phase 5's float32
   inputs (x within 1e-3 relative);
10. pose refinement on the gather kernels (K1 gather_project, K2
   gather_backproject, K3 pose_jacobian, K4 sym_normal): (a) each against
   its plain version at phase 9 (b)'s best golden candidate at tilt 3 deg,
   nn and linear (P within 1e-5 of its max, PT and ST(S(x)) bit for bit,
   J^T J and J^T r 1e-4 relative), timed beside its plain version, its
   bound and a yardstick (grid_sample + the ray sum for P, index_add_ for
   nn PT), and K4's share of a refine matvec beside the torch S + ST it
   replaced; (b) phase 9 (b)'s wall on the kernels beside the torch gather
   projector's; (c) refinement's main path, the CLI's refinement
   (--refineTiltPsiDy 5 5 2, top-1) on phase 4's search, K1-K4's counts
   zeroed just before and read just after (the wall split into search,
   refine and re-solve; the pose inside its bounds), then at the refined
   candidate's own tables (tilt 0, C = 196) K1-K4 against plain, one
   Gauss-Newton step (1e-4) and the whole refinement (poses 5e-3, scores
   5e-4) on the kernels against plain; (d) refine_mode "all" on the golden
   grid at max_iter 5, twice (scores and poses bit for bit), and the
   winner's and the furthest mover's whole refinements on the kernels
   against plain (5e-3 / 5e-4) and against a second run on the kernels
   (bit for bit). Each line of phase 10 ends with the card's name and
   power limit.

The last two lines of standard output are the card's name and power
limit, and {"ok": true, "device": {...}}; the line before them lists each
kernel with its launches on its own path (phase 4 for B1, phase 5 for B2
and B3, phase 10 (c) for K1-K4; B1's and B2's on the bucketed path of
phase 8, B2's on phase 9's per-candidate searches too, with its matvec
entry and its j-dependent z-Gram; K1-K4's on phases 9 (b) and 10 (d)),
its error against the plain version, its time, the plain
version's time and the least time the card could take for the same work
(inputs larger than the 50 MB L2 counted once per matvec that reads them;
bound_two_pass_ms counts the stacked operand once per product).
The smoke's total time is printed before those two lines. It imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AMYLOID = ROOT / "tests" / "data" / "class_avg_amyloid.npy"
CSRC = "helicon_tpu_torch/denovo3d/csrc/"
ITERS = (10, 16, 2)  # cg / fista / power, the bench's budget (bench.py:302-306)
# the JAX package's top-1 of the linear golden (tests/test_torch_candidate_solve.py)
LINEAR_GOLDEN_TOP1 = (2.0, 4.75)
# peak rates of one H100 SXM (dense): bf16 tensor cores, float32 outside
# them, device memory
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
L2_BYTES = 50e6  # an input larger than this is streamed from memory by each pass


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


def _host_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call of reps calls issued back to back,
    without waiting for the card: near _time_ms's figure, the calls are
    bound by the host (the card waits for them); far below it, by the
    card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _bound(nbytes, mma_flops, simt_flops, bf16) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type (the products'
    on the tensor cores in bf16, all else on the float32 units)."""
    t_ops = mma_flops / (PEAK_BF16 if bf16 else PEAK_F32) + simt_flops / PEAK_F32
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _matvecs(cg, fista, power) -> int:
    return cg + (power + 1 + fista if fista > 0 else 0)


def _real_size_grid():
    """Phase 4's (twists, rises): 179 twists x 13 rises, left-handed."""
    from helicon_tpu_torch.denovo3d import build_candidate_grid

    return build_candidate_grid(0.5, 45.0, 0.25, 4.0, 5.0, 0.08, handedness="left")


def _golden_grid():
    """Phases 3, 6 and 7's 45-candidate golden grid (twists x rises)."""
    from helicon_tpu_torch.denovo3d import build_candidate_grid

    return build_candidate_grid(1.0, 3.0, 0.25, 4.45, 5.06, 0.15, handedness="left")


def _amyloid_setup():
    """Phase 4's geometry and tables as reconstruct_grid derives them: the
    amyloid at 2 A/px, tube 110 A, the grid's rises, default settings."""
    import numpy as np

    from helicon_tpu_torch.core.filters import down_scale
    from helicon_tpu_torch.denovo3d.geometry import (
        ReconstructionGeometry, estimate_copy_pair_counts, estimate_n_pair_ops,
        select_copies,
    )
    from helicon_tpu_torch.denovo3d.pipeline import (
        _pixel_geometry, auto_sym_oversample, derive_task_geometry,
    )

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
    ny, nx = img.shape
    region = img[ny // 2 - geom.d2 // 2 : ny // 2 + geom.d2 // 2,
                 nx // 2 - geom.l2 // 2 : nx // 2 + geom.l2 // 2]
    return dict(geom=geom, region=region, tw_all=tw_all, rp_all=rp_all, n_copies=n_copies,
                n_pairs=n_pairs, n_ops=n_ops, C_u=len(u))


def _amyloid_groups(device, cdt, twists, pid_mask=None):
    """Solve inputs of phase 4's twist groups for ``twists`` (one group
    each, G = len(twists)), built by the port on ``device`` as
    reconstruct_grid builds them (with pid_mask (l2, d2): an fsc half-set's
    inputs), and each candidate's data-row count (G, R), the scale of a
    per-row regularization (grid.py)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import grid as G
    from helicon_tpu_torch.denovo3d.group_solve import GroupInputs, group_inputs
    from helicon_tpu_torch.denovo3d.projector_grouped import (
        build_candidate_tensors_grouped, build_group_shared,
    )
    from helicon_tpu_torch.denovo3d.solver import SolveConfig

    a = _amyloid_setup()
    geom, region, tw_all, rp_all = a["geom"], a["region"], a["tw_all"], a["rp_all"]
    n_copies, n_pairs, n_ops = a["n_copies"], a["n_pairs"], a["n_ops"]
    hmax = (n_ops - 1) // 2
    ops_h = np.arange(-hmax, hmax + 1).astype(np.int32)
    inp, rows = None, []
    for gi, twist in enumerate(twists):
        rp = rp_all[tw_all == np.float32(twist)]
        rpad, m, ch_u, cc_u, pidx, pval, _ = G._group_tables(
            geom, float(twist), rp, n_copies, n_pairs, n_ops, a["C_u"], len(rp), {}
        )
        shared = build_group_shared(geom, np.float32(twist), ch_u, cc_u, ops_h,
                                    np.zeros_like(ops_h), np.float32(0.0), "nn",
                                    geom.cylindrical_mask(), geom.cell_valid_mask(), cdt,
                                    device)
        tens = build_candidate_tensors_grouped(shared, geom, region, rpad, np.sqrt(m),
                                               pidx, pval, pid_mask=pid_mask)
        rows.append(np.maximum(m.sum(axis=1), 1.0) * np.float32(geom.d2 * geom.l2))
        tens["lb"], tens["ub"] = G._box_bounds(
            G._positive(SolveConfig(), rpad, float(twist), geom.l3), tens["ub_raw"])
        one = group_inputs(shared, tens)
        if inp is None:
            inp = GroupInputs.empty(len(twists), one)
        inp.put(gi, one)
        del shared, tens, one
    return geom, a["C_u"], inp, torch.from_numpy(np.stack(rows).astype(np.float32)).to(device)


def _streamed(t, passes: int) -> int:
    """Bytes of t read by ``passes`` passes: each pass streams it from
    memory if it exceeds the L2, else it is read once."""
    n = _nbytes(t)
    return n * passes if n > L2_BYTES else n


def _group_work(inp, iters, a_passes: int = 1, with_score: bool = True) -> tuple:
    """(bytes, product FLOP, other FLOP) the grouped solve needs: each
    input read once, except those larger than the L2 (A_top, af, deg at
    phase 4's size), read once per matvec (A_top ``a_passes`` times: 2 for
    a design whose two products each stream it); with the score, its pass
    reads A_top's data rows once more; x and the scores written once. Two
    products per matvec and, with the score, its data-column product; the
    z-Gram mix (once more for the score), the op-axis glue and the vector
    updates."""
    G, R, C_u, O, l3, d3sq = inp.shape
    M, rows, nd = R * l3, inp.a_top.shape[1], C_u * inp.d2
    nm = _matvecs(*iters)
    sc = int(with_score)
    mma = G * (nm * 2 * 2 * M * rows * d3sq + sc * 2 * M * nd * d3sq)
    simt = G * ((nm + sc) * 2 * M * l3 * nd + nm * R * d3sq * O * l3 * (4 * l3 + 2 * O + 4)
                + nm * 10 * M * d3sq)
    small = (inp.gz, inp.mz, inp.cn, inp.mask, inp.rhs, inp.lb, inp.ub, inp.bn)
    nbytes = (_streamed(inp.a_top, a_passes * nm) + _streamed(inp.af, nm)
              + _streamed(inp.deg, nm) + _nbytes(*small)
              + sc * G * nd * d3sq * inp.a_top.element_size() + 4 * G * (M * d3sq + R))
    return nbytes, mma, simt


def phase_kernel_vs_plain(device) -> dict:
    """Phase 2: the kernel and its plain version on the same CUDA tensors:
    one group (twist 2.0 deg) in float32 and in bfloat16, then all 179
    distinct twist groups of phase 4 in one bfloat16 call (its G), with
    cuBLAS's time for the two products of one of its matvecs."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import group_solve as gs

    row = {}
    main_twists = np.unique(_real_size_grid()[0])
    # (name, dtype, score abs limit, x relative limit, twists)
    cases = (("float32", torch.float32, 1e-4, 1e-3, [2.0]),
             ("bfloat16", torch.bfloat16, 1e-3, 5e-3, [2.0]),
             ("bfloat16", torch.bfloat16, 1e-3, 5e-3, main_twists))
    for name, cdt, score_tol, x_tol, twists in cases:
        geom, C_u, inp, _ = _amyloid_groups(device, cdt, twists)
        G = len(twists)
        x_k, s_k = gs.solve_group(inp, *ITERS)
        x_p, s_p = gs.solve_group_reference(inp, *ITERS)
        torch.cuda.synchronize()
        score_err = float((s_k - s_p).abs().max())
        x_rel = float((x_k - x_p).abs().max() / x_p.abs().max().clamp_min(1e-30))
        reps = 5 if G == 1 else 2
        ms_k = _time_ms(lambda: gs.solve_group(inp, *ITERS), reps)
        ms_p = _time_ms(lambda: gs.solve_group_reference(inp, *ITERS), reps)
        _, R, _, O, l3, d3sq = inp.shape
        bf16 = cdt == torch.bfloat16
        bound_ms, bound_by = _bound(*_group_work(inp, ITERS), bf16=bf16)
        two_pass_ms, _ = _bound(*_group_work(inp, ITERS, a_passes=2), bf16=bf16)
        print(f"phase 2 [{name}, G={G} distinct twist groups] d3={geom.d3} l3={l3} "
              f"C_u={C_u} O={O} R={R} A_top={tuple(inp.a_top.shape[1:])} (row pitch "
              f"{inp.a_top.stride(1)}): score abs err {score_err:.3e} (limit {score_tol:g}), "
              f"x rel err {x_rel:.3e} (limit {x_tol:g}), kernel {ms_k:.3f} ms, plain "
              f"{ms_p:.3f} ms per call, bound {bound_ms:.3f} ms ({bound_by}; {two_pass_ms:.3f} "
              f"ms if each product streams A_top)", flush=True)
        if not (score_err <= score_tol):
            raise AssertionError(f"{name} kernel scores differ from plain by {score_err}")
        if not (x_rel <= x_tol):
            raise AssertionError(f"{name} kernel x differs from plain by {x_rel} relative")
        row[(name, G)] = dict(max_abs_err=score_err, x_rel_err=x_rel, ms=ms_k, plain_ms=ms_p,
                              bound_ms=bound_ms, bound_by=bound_by, groups=(G, R, C_u, O),
                              bound_two_pass_ms=two_pass_ms)
        if cdt == torch.bfloat16 and G == 1:
            # bf16's own noise: the plain version with A_top in float32
            x_f, s_f = gs.solve_group_reference(dataclasses.replace(inp, a_top=inp.a_top.float()),
                                                *ITERS)
            print(f"phase 2 [{name}, G={G}]: plain bf16 against plain float32: score abs diff "
                  f"{float((s_p - s_f).abs().max()):.3e}, x rel diff "
                  f"{float((x_p - x_f).abs().max() / x_f.abs().max()):.3e}", flush=True)
            del x_f
        del x_k, x_p
        if G > 1 or not bf16:
            row[(name, G)]["products"] = _time_products(
                inp.a_top, R * l3, f"phase 2 [{name}, G={G}]",
                gs.padded_pitch(inp.a_top.shape[1]))
        del inp
        torch.cuda.empty_cache()
    return row


def _time_products(A, M: int, label: str, gm_pitch: int) -> dict:
    """Each product of one matvec alone, at the solve's shapes and pitches
    (A (G, rows, d3^2) as the solve holds it, Gm's rows gm_pitch elements
    apart), in ms and in TB/s of A, beside cuBLAS's bmm for the same
    product in A's dtype, TF32 off (the yardstick of a redesign: no
    PyTorch call computes the solve). The first product includes its
    float32 -> bf16 cast of X in bf16, the second stops before its split
    sum."""
    import torch

    from helicon_tpu_torch.denovo3d import group_solve as gs

    G, rows, d3sq = A.shape
    gen = torch.Generator(device=A.device).manual_seed(0)
    X = torch.randn((G, M, d3sq), device=A.device, generator=gen)
    Xb = X.to(A.dtype)
    Gm = torch.empty((G, M, gm_pitch), dtype=A.dtype, device=A.device)[..., :rows]
    Gm.copy_(torch.randn((G, M, rows), device=A.device, generator=gen))
    tb_s = lambda ms: _nbytes(A) / (ms * 1e-3) / 1e12  # noqa: E731
    out = {}
    for key, kernel, library in (
        ("first (T = X . A^T)", lambda: gs.gemm_xat(X, A),
         lambda: torch.bmm(Xb, A.transpose(1, 2))),
        ("second (Y = Gm . A)", lambda: gs.gemm_ga(Gm, A), lambda: torch.bmm(Gm, A)),
    ):
        ms, lib_ms = _time_ms(kernel, 10), _time_ms(library, 10)
        out[key.split()[0]] = dict(ms=ms, tb_s=tb_s(ms), cublas_ms=lib_ms, cublas_tb_s=tb_s(lib_ms))
        print(f"{label}: {key} product alone (M={M}) {ms:.3f} ms = {tb_s(ms):.3f} TB/s of A; "
              f"cuBLAS bmm {lib_ms:.3f} ms = {tb_s(lib_ms):.3f} TB/s", flush=True)
    mv = sum(v["ms"] for v in out.values())
    mv_lib = sum(v["cublas_ms"] for v in out.values())
    print(f"{label}: the two products of one matvec {mv:.3f} ms (cuBLAS "
          f"{mv_lib:.3f} ms), x {_matvecs(*ITERS)} matvecs = {mv * _matvecs(*ITERS):.3f} ms "
          f"(cuBLAS {mv_lib * _matvecs(*ITERS):.3f} ms)", flush=True)
    return out


def phase_golden(device, interpolation="nn", top1=(2.0, 4.75)) -> None:
    """Phase 3 (and 6): the 45-candidate amyloid golden through
    reconstruct_grid in float32 and bfloat16. The float32 top-1 must be
    ``top1``. For nn the bf16 top-1 must be too; for linear, whose two best
    candidates lie 1.1e-4 apart in float32, under the bf16 solve's own
    noise (PERF.md, ROADMAP C9), the bf16 run is held to the reference's bf16
    contract: every score within 5e-3 of float32's, and its top-1 a
    candidate within 3e-4 of the float32 best (the reference's measured
    bf16 score delta, helicon_tpu/denovo3d/grid.py:1061-1064)."""
    import numpy as np

    from helicon_tpu_torch.denovo3d import reconstruct_grid

    img = np.load(AMYLOID)
    tw, ri = _golden_grid()
    phase = 3 if interpolation == "nn" else 6
    f32 = None
    for dtype in ("float32", "auto"):
        t0 = time.perf_counter()
        res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                               cg_iters=10, fista_iters=16, power_iters=2,
                               compute_dtype=dtype, return_best_volume=False,
                               interpolation=interpolation, device=device)
        best_tw, best_ri, best_s = res.top(1)[0]
        print(f"phase {phase} [{interpolation}, {res.effective['compute_dtype']}] {len(tw)} "
              f"candidates in {time.perf_counter() - t0:.2f} s, top-1 ({best_tw}, {best_ri}) "
              f"score {best_s:.6f}; top-3 {res.top(3).tolist()}", flush=True)
        if f32 is None:
            f32 = res.scores
        elif interpolation != "nn":
            delta = float(np.abs(res.scores - f32).max())
            gap = float(f32.max() - f32[res.best_index])
            print(f"phase {phase} [{interpolation}, bfloat16]: max |score - float32's| "
                  f"{delta:.3e} (limit 5e-3); its top-1 lies {gap:.3e} below the float32 "
                  f"best (limit 3e-4); top-1 {'equals' if (float(best_tw), float(best_ri)) == top1 else 'differs from'} "
                  f"the JAX package's float32 top-1 {top1}", flush=True)
            if not (delta <= 5e-3 and gap <= 3e-4):
                raise AssertionError(f"{interpolation} bf16 golden off its float32 run: "
                                     f"delta {delta}, gap {gap}")
            continue
        if (float(best_tw), float(best_ri)) != top1:
            raise AssertionError(f"{interpolation} golden top-1 is ({best_tw}, {best_ri}), "
                                 f"not {top1}")


def phase_real_size(device, interpolation="nn"):
    """Phase 4 (and 6): the amyloid search at its own pixel size; returns
    the result and the group-solve kernel launches of the run."""
    import numpy as np

    tw, ri = _real_size_grid()
    res, launches, wall, peak = _search(device, tw, ri, return_best_volume=True,
                                        interpolation=interpolation)
    geom, eff = res.geom, res.effective
    print(f"phase {4 if interpolation == 'nn' else 6} [{interpolation}]: {len(tw)} candidates, "
          f"{eff['n_groups']} groups of R={eff['R']}, "
          f"G={eff['groups_per_launch']} groups per launch, C_u={eff['C_u']}, "
          f"d2={geom.d2} l2={geom.l2} d3={geom.d3} l3={geom.l3}, {eff['compute_dtype']}: "
          f"{wall:.3f} s wall incl. best volume, {len(tw) / wall:.1f} candidates/s, "
          f"peak {peak:.2f} GiB, {launches} kernel launches; operator build {eff['build_s']:.3f} s, solve "
          f"{eff['solve_s']:.3f} s; top-1 {tuple(float(v) for v in res.top(1)[0])}", flush=True)
    _check_search(res, launches, interpolation)
    return res, launches


def _check_search(res, launches: int, label: str) -> None:
    """A search's result: B1 launched, every score finite, the best volume
    finite and of shape (l3, d3, d3)."""
    import numpy as np

    geom, bv = res.geom, res.best_volume
    if launches <= 0:
        raise AssertionError(f"{label}: the search did not launch the group-solve kernel")
    if not np.all(np.isfinite(res.scores)):
        raise AssertionError(f"{label}: non-finite scores")
    if bv is None or bv.shape != (geom.l3, geom.d3, geom.d3) or not np.all(np.isfinite(bv)):
        raise AssertionError(f"{label}: best volume missing, misshapen or non-finite")


def _top_candidates(device, res, n: int):
    """The n best candidates of phase 4, each built as the best-volume
    re-solve builds it (grid.py: _candidate_tables, the nn dedup mask,
    build_problem_separable), in float32, for both interpolations."""
    import numpy as np

    from helicon_tpu_torch.denovo3d import grid as G
    from helicon_tpu_torch.denovo3d.geometry import compute_sym_dedup_mask
    from helicon_tpu_torch.denovo3d.projector_separable import build_problem_separable
    from helicon_tpu_torch.denovo3d.solver import SolveConfig, _positive

    a = _amyloid_setup()
    geom, region = a["geom"], a["region"]
    if not np.array_equal(res.twists, a["tw_all"]):
        raise AssertionError("phase 4's grid is not the one rebuilt here")
    idx = np.argsort(-res.scores)[:n]
    tw, rp = a["tw_all"][idx], a["rp_all"][idx]
    cfg = SolveConfig(cg_iters=ITERS[0], fista_iters=ITERS[1], power_iters=ITERS[2],
                      separable=True)
    out = []
    for i in range(n):
        tabs = G._candidate_tables(geom, tw[i : i + 1], rp[i : i + 1], a["n_copies"],
                                   a["n_pairs"], a["n_ops"])
        ch, cc, cv, phc, pv, ops_hc, ops_v, pidx = (t[0] for t in tabs)
        keep = compute_sym_dedup_mask(geom, float(tw[i]), float(rp[i]), phc, pv)
        cand = dict(geom=geom, region=region, twist=tw[i], rise=rp[i], cfg=cfg, keep=keep,
                    tables=(ch, cc, cv, phc, pv), pair_ops=(ops_hc, ops_v, pidx))
        for interp in ("nn", "linear"):
            ops = build_problem_separable(
                geom, region, tw[i], rp[i], ch, cc, cv, phc, pv, np.float32(0.0), interp,
                geom.cylindrical_mask(), geom.cell_valid_mask(), compute_dtype=None,
                pair_ops=(ops_hc, ops_v, pidx), sym_keep=keep if interp == "nn" else None,
                device=device,
            )
            b_eff = ops["b"][None] * ops["row_valid"].float()
            box = ((0.0, float(b_eff.max()))
                   if _positive(cfg, float(rp[i]), float(tw[i]), geom.l3)
                   else (-float("inf"), float("inf")))
            cand[interp] = dict(ops=ops, rhs=ops["PT"](b_eff) * ops["mask"].float(), box=box)
        out.append(cand)
    return out


def _single_work(inp, a_passes: int = 1, nm: int | None = None) -> tuple:
    """(bytes, product FLOP, other FLOP) of B2 on CandidateInputs, or of
    B3 on FullInputs (its build, rhs product and the score's data term
    too): each input read once, except one larger than the L2 (B2's
    stacked operand), read once per matvec (``a_passes`` times: 2 for a
    design whose two products each stream it); B3's built operand written
    once and read as B2's, its data rows read once more by the rhs pass
    and once by the score; x (and the score) written once. nm: the
    matvecs (the solve's by default; 1 for the matvec entry alone)."""
    import torch

    k, C, O, l3, d3sq = inp.shape
    nd, PL = C * inp.d2, inp.b1.shape[1]
    rows = nd + O * d3sq
    nm = _matvecs(*ITERS) if nm is None else nm
    mma = k * nm * 2 * 2 * l3 * rows * d3sq
    simt = k * nm * (2 * l3 * l3 * nd + 4 * PL * O * l3 * d3sq + 13 * l3 * d3sq)
    fields = [getattr(inp, f.name) for f in dataclasses.fields(inp)]
    a_top = getattr(inp, "a_top", None)  # B2's operand; B3 builds its own (below)
    nbytes = sum(_streamed(t, nm * (a_passes if t is a_top else 1)) for t in fields
                 if isinstance(t, torch.Tensor))
    nbytes += 4 * k * l3 * d3sq
    if hasattr(inp, "theta"):  # B3
        mma += k * 3 * 2 * l3 * nd * d3sq
        simt += k * (2 * l3 * l3 * nd + nd * d3sq * (14 + 6 * (2 * inp.n_taps + 1))
                     + O * d3sq * (8 + d3sq))
        el = torch.empty((), dtype=inp.cdt).element_size()
        a_bytes = k * rows * d3sq * el
        nbytes += a_bytes + (a_bytes * a_passes * nm if a_bytes > L2_BYTES else 0)
        nbytes += 2 * k * nd * d3sq * el + 4 * k
    return nbytes, mma, simt


# the launch groups of one B2 solve, by C entry; every other entry is a
# vector update (CG, power iteration, FISTA, the mask)
_B2_GROUPS = {"hts_gemm_xat": "first product", "hts_glue_data": "glue_data",
              "hcs_sym_fold": "sym_fold", "hts_gemm_ga": "second product",
              "hcs_reduce_l2_mask": "reduce_l2_mask"}


def _b2_breakdown(inp) -> dict:
    """Device ms of each launch group of one B2 call, summed over the
    solve: CUDA events around every C entry call, after a warm-up call.
    The events cost host time between launches, so the sum is the
    kernels' own time, not the call's."""
    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve as cs

    launch = cs._launcher("solve_candidate", inp.a_top.device)
    events = []

    def run(name, *args, kernels=1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch(name, *args, kernels=kernels)
        end.record()
        events.append((_B2_GROUPS.get(name, "vector updates"), start, end))

    args = (inp.a_top, inp.gz, inp.b1, inp.pok, inp.mask, inp.rhs, inp.scal, inp.d2, *ITERS)
    for _ in range(2):  # warm-up, then the measured call
        events.clear()
        cs._solve_cuda(run, *args)
    torch.cuda.synchronize()
    out = {g: 0.0 for g in list(_B2_GROUPS.values()) + ["vector updates"]}
    for g, start, end in events:
        out[g] += start.elapsed_time(end)
    return out


def phase_single_candidate(device, res) -> dict:
    """Phase 5: validate_on_gpu, then B2 and B3 at full width on the top 8
    candidates of phase 4. The kernels run once with the launch counts
    set to 0 (the path these kernels serve), then their plain versions,
    the checks and the times."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve as cs
    from helicon_tpu_torch.denovo3d.solver import solve_candidate

    v = cs.validate_on_gpu()
    print(f"phase 5: validate_on_gpu {json.dumps(v)}", flush=True)
    if not v["ok"]:
        raise AssertionError(f"validate_on_gpu failed: {v}")
    cands = _top_candidates(device, res, 8)
    geom = cands[0]["geom"]
    inputs = {}
    for cdt in (torch.float32, torch.bfloat16):
        name = "float32" if cdt == torch.float32 else "bfloat16"
        for interp in ("nn", "linear"):
            inputs[("solve_candidate", interp, name)] = cs.CandidateInputs.stack([
                cs.candidate_inputs(c[interp]["ops"]["factors"], cdt, c[interp]["rhs"],
                                    (0.01, 0.001) + c[interp]["box"]) for c in cands])
        inputs[("score_candidate", "nn", name)] = cs.FullInputs.stack([
            cs.full_kernel_inputs(geom, c["nn"]["ops"], c["twist"], c["rise"], *c["tables"][:3],
                                  c["pair_ops"][0], cdt, scal=(0.0, 0.0) + c["nn"]["box"])
            for c in cands])

    def run(key, kernel):
        inp = inputs[key]
        if key[0] == "solve_candidate":
            f = cs.solve_candidate_kernel if kernel else cs.solve_candidate_reference
            return f(inp, *ITERS), None
        f = cs.score_candidate_kernel if kernel else cs.score_candidate_reference
        return f(inp, *ITERS)

    # the kernels' own path: every launch counted
    for k in cs.launches:
        cs.launches[k] = 0
    torch.cuda.synchronize()
    out_k = {key: run(key, True) for key in inputs}
    torch.cuda.synchronize()
    launches = {k: cs.launches[k] for k in ("solve_candidate", "score_candidate")}
    print(f"phase 5: kernel launches {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"phase 5 did not launch {k}")

    rows = {}
    for key, (x_k, s_k) in out_k.items():
        kind, interp, name = key
        x_p, s_p = run(key, False)
        torch.cuda.synchronize()
        x_rel = float((x_k - x_p).abs().max() / x_p.abs().max().clamp_min(1e-30))
        x_abs = float((x_k - x_p).abs().max())
        score_err = None if s_k is None else float((s_k - s_p).abs().max())
        score_tol, x_tol = (1e-4, 1e-3) if name == "float32" else (1e-3, 5e-3)
        if not bool(torch.isfinite(x_k).all()) or not (x_rel <= x_tol):
            raise AssertionError(f"{key}: x differs from plain by {x_rel} relative")
        if score_err is not None and not (score_err <= score_tol):
            raise AssertionError(f"{key}: scores differ from plain by {score_err}")
        inp = inputs[key]
        reps = 3
        ms_k = _time_ms(lambda: run(key, True), reps)
        ms_p = _time_ms(lambda: run(key, False), reps)
        bf16 = name == "bfloat16"
        bound_ms, bound_by = _bound(*_single_work(inp), bf16=bf16)
        two_pass_ms, _ = _bound(*_single_work(inp, a_passes=2), bf16=bf16)
        label = (f"phase 5 [{kind}, {interp}, {name}, k={inp.shape[0]} candidates, "
                 f"C={inp.shape[1]} O={inp.shape[2]} l3={inp.shape[3]} d3^2={inp.shape[4]}]")
        print(f"{label}: x rel err {x_rel:.3e} (limit {x_tol:g})"
              + ("" if score_err is None else f", score abs err {score_err:.3e} (limit "
                 f"{score_tol:g})")
              + f", kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms per call, bound {bound_ms:.3f} ms "
              f"({bound_by}; {two_pass_ms:.3f} ms if each product streams A)", flush=True)
        rows[key] = dict(max_abs_err=x_abs if score_err is None else score_err, ms=ms_k,
                         plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
                         bound_two_pass_ms=two_pass_ms)
        if kind == "solve_candidate" and interp == "nn":
            parts = _b2_breakdown(inp)
            total = sum(parts.values())
            print(f"{label}: device time by launch group, summed over one solve: "
                  + ", ".join(f"{g} {t:.3f} ms ({100 * t / total:.1f} %)"
                              for g, t in parts.items())
                  + f"; sum {total:.3f} ms", flush=True)
            rows[key]["breakdown_ms"] = parts
            if not bf16:
                rows[key]["products"] = _time_products(inp.a_top, inp.shape[3], label,
                                                       inp.a_top.shape[1])

    for name in ("float32", "bfloat16"):
        fin = inputs[("score_candidate", "nn", name)]
        if not torch.equal(cs.build_operators(fin), cs.build_operators_reference(fin)):
            raise AssertionError(f"B3's built W2 / Mxy ({name}) differ from the plain build")
    print("phase 5: B3's built W2 and Mxy are bit-identical to the plain build "
          "(float32 and bfloat16)", flush=True)

    # B3's float32 scores against the port's closure path
    s_b3 = out_k[("score_candidate", "nn", "float32")][1].cpu().numpy()
    s_cl = []
    for c in cands:
        r = solve_candidate(geom, c["cfg"], c["region"], c["twist"], c["rise"], *c["tables"],
                            dy_pixel=np.float32(0.0), pair_ops=c["pair_ops"], sym_keep=c["keep"],
                            device=device)
        s_cl.append(float(r["score"]))
    err = float(np.abs(s_b3 - np.asarray(s_cl)).max())
    print(f"phase 5: B3 float32 scores vs solver.solve_candidate (B2): max abs err {err:.3e} "
          f"(limit 1e-4); scores {np.round(s_b3, 6).tolist()}", flush=True)
    if not (err <= 1e-4):
        raise AssertionError(f"B3 scores differ from solve_candidate's by {err}")
    return dict(launches=launches, rows=rows, inputs=inputs, cands=cands)


# phase 7's full-width configurations (reconstruct_grid keyword arguments)
ENVELOPE = (
    ("ridge", dict(algorithm=dict(model="ridge"))),
    ("lasso", dict(algorithm=dict(model="lasso"))),
    ("elasticnet", dict(algorithm=dict(model="elasticnet"))),
    ("lreg", dict(algorithm=dict(model="lreg"))),
    ("thresh", dict(thresh_fraction=0.1)),
    ("ssim", dict(score_metric="ssim")),
    ("ms_ssim", dict(score_metric="ms_ssim")),
    ("mutual_information", dict(score_metric="mutual_information")),
    ("composite", dict(score_metric="composite")),
    ("fsc2", dict(fsc_test=2)),
)
# elasticnet's per-row coefficients at regularization_from_algorithm's
# defaults (alpha 1e-4, l1_ratio 0.5): l1 = l2 = 5e-5 per data row
EN_PER_ROW = 5e-5


def phase_envelope_kernel(device) -> dict:
    """Phase 7 (a)-(b): validate_grouped_on_gpu, then B1's options against
    the plain version on the same CUDA tensors, on one amyloid group
    (twist 2.0 deg) in float32 and bf16 (phase 2's gates): l1 + l2 columns
    (elasticnet's defaults) without the score, and an fsc half-set's
    j-dependent z-Gram (mode 2's first half) with it; then, at phase 4's G
    = 179 in bf16, the time per call of the lsq solve, of the solve with
    an l2 column, with l1 + l2, and of an fsc half-set solve."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import group_solve as gs
    from helicon_tpu_torch.denovo3d.solver import _pid_split_masks

    v = gs.validate_grouped_on_gpu()
    print(f"phase 7: validate_grouped_on_gpu {json.dumps(v)}", flush=True)
    if not v["ok"]:
        raise AssertionError(f"validate_grouped_on_gpu failed: {v}")
    half = _pid_split_masks(_amyloid_setup()["geom"], 2)[0][0]
    out = {}
    for name, cdt, score_tol, x_tol in (("float32", torch.float32, 1e-4, 1e-3),
                                        ("bfloat16", torch.bfloat16, 1e-3, 5e-3)):
        for option in ("l1_l2_no_score", "fsc_half"):
            fsc = option == "fsc_half"
            _, _, inp, rows = _amyloid_groups(device, cdt, [2.0], pid_mask=half if fsc else None)
            kw = {} if fsc else dict(l1=rows * EN_PER_ROW, l2=rows * EN_PER_ROW, with_score=False)
            x_k, s_k = gs.solve_group(inp, *ITERS, **kw)
            x_p, s_p = gs.solve_group_reference(inp, *ITERS, **kw)
            torch.cuda.synchronize()
            score_err = float((s_k - s_p).abs().max())
            x_rel = float((x_k - x_p).abs().max() / x_p.abs().max().clamp_min(1e-30))
            print(f"phase 7 [{option}, {name}, G=1]: score abs err {score_err:.3e} (limit "
                  f"{score_tol:g}), x rel err {x_rel:.3e} (limit {x_tol:g}), |x| max "
                  f"{float(x_k.abs().max()):.4g}", flush=True)
            if not bool(torch.isfinite(x_k).all()) or not (score_err <= score_tol
                                                            and x_rel <= x_tol):
                raise AssertionError(f"B1 {option} ({name}) differs from plain: scores "
                                     f"{score_err}, x {x_rel} relative")
            out[(option, name)] = dict(score_abs_err=score_err, x_rel_err=x_rel)
            del inp, x_k, x_p

    twists = np.unique(_real_size_grid()[0])
    _, _, inp, rows = _amyloid_groups(device, torch.bfloat16, twists)
    G, R, C_u, O, l3, d3sq = inp.shape
    l1c = l2c = rows * EN_PER_ROW
    ms_lsq = _time_ms(lambda: gs.solve_group(inp, *ITERS), 2)
    ms_l2 = _time_ms(lambda: gs.solve_group(inp, *ITERS, l2=l2c, with_score=False), 2)
    ms_en = _time_ms(lambda: gs.solve_group(inp, *ITERS, l1=l1c, l2=l2c, with_score=False), 2)
    plain_en = _time_ms(
        lambda: gs.solve_group_reference(inp, *ITERS, l1=l1c, l2=l2c, with_score=False), 1)
    nbytes, mma, simt = _group_work(inp, ITERS, with_score=False)
    # the ridge term reads x once more per matvec
    nm = _matvecs(*ITERS)
    en_bound, en_by = _bound(nbytes + nm * 4 * G * R * l3 * d3sq, mma, simt, bf16=True)
    del inp
    torch.cuda.empty_cache()
    _, _, inp_h, _ = _amyloid_groups(device, torch.bfloat16, twists, pid_mask=half)
    ms_half = _time_ms(lambda: gs.solve_group(inp_h, *ITERS), 2)
    nbytes, mma, simt = _group_work(inp_h, ITERS)
    # the j-dependent z-Gram (larger than the L2) is read by every matvec
    nbytes += _streamed(inp_h.gz, nm + 1) - _nbytes(inp_h.gz)
    half_bound, half_by = _bound(nbytes, mma, simt, bf16=True)
    gz_gb = _nbytes(inp_h.gz) / 1e9
    del inp_h
    torch.cuda.empty_cache()
    print(f"phase 7 [bfloat16, G={G}]: lsq {ms_lsq:.3f} ms, with an l2 column {ms_l2:.3f} ms, "
          f"with l1 + l2 {ms_en:.3f} ms (plain {plain_en:.3f} ms, bound {en_bound:.3f} ms, "
          f"{en_by}) per call; an fsc half-set solve {ms_half:.3f} ms (bound {half_bound:.3f} "
          f"ms, {half_by}; its z-Gram {gz_gb:.2f} GB)", flush=True)
    out["timing"] = dict(lsq_ms=ms_lsq, l2_ms=ms_l2, ms=ms_en, plain_ms=plain_en,
                         bound_ms=en_bound, bound_by=en_by, fsc_half_ms=ms_half,
                         fsc_half_bound_ms=half_bound, fsc_half_bound_by=half_by)
    return out


def _search(device, tw, ri, **kw):
    """One reconstruct_grid on the amyloid with B1's launches counted:
    returns (result, launches, wall s, peak GiB)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import group_solve, reconstruct_grid

    img = np.load(AMYLOID)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group_solve.launches = 0
    t0 = time.perf_counter()
    res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                           cg_iters=10, fista_iters=16, power_iters=2, device=device, **kw)
    torch.cuda.synchronize()
    return (res, group_solve.launches, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def phase_envelope_search(device) -> dict:
    """Phase 7 (c): phase 4's 2,327-candidate search (bf16, best-volume
    re-solve) under each configuration of ENVELOPE, with its times, retry
    rounds, B1 launches, peak memory and top-1; every score and the volume
    finite and B1 launched. Then the 45-candidate golden grid of the same
    configuration in float32 and bf16: every bf16 score within 5e-3 of
    float32's. Returns each configuration's full-width result."""
    import numpy as np

    tw, ri = _real_size_grid()
    gtw, gri = _golden_grid()
    out = {}
    for name, kw in ENVELOPE:
        res, launches, wall, peak = _search(device, tw, ri, return_best_volume=True, **kw)
        e = res.effective
        print(f"phase 7 [{name}]: {len(tw)} candidates, {wall:.3f} s wall incl. best volume, "
              f"{len(tw) / wall:.1f} candidates/s; build {e['build_s']:.3f} s, solve "
              f"{e['solve_s']:.3f} s, score {e['score_s']:.3f} s (in kernel: "
              f"{e['score_in_kernel']}); retry rounds {e['retry_rounds']}; {launches} B1 "
              f"launches; peak {peak:.2f} GiB; top-1 "
              f"{tuple(float(v) for v in res.top(1)[0])}", flush=True)
        _check_search(res, launches, name)
        g = [_search(device, gtw, gri, return_best_volume=False, compute_dtype=d, **kw)[0]
             for d in ("float32", "auto")]
        delta = float(np.abs(g[1].scores - g[0].scores).max())
        print(f"phase 7 [{name}] golden: max |bf16 - float32| {delta:.3e} (limit 5e-3); "
              f"top-1 float32 {tuple(float(v) for v in g[0].top(1)[0][:2])}, bf16 "
              f"{tuple(float(v) for v in g[1].top(1)[0][:2])}", flush=True)
        if not (delta <= 5e-3):
            raise AssertionError(f"{name}: golden bf16 scores {delta} off float32's")
        out[name] = dict(res=res, launches=launches, wall=wall, peak=peak, golden_delta=delta)
    return out


def phase_c10(device, bf16_runs) -> dict:
    """ROADMAP C10: float32 runs of the full-width searches of
    ``bf16_runs`` ({name: (bf16 scores, reconstruct_grid kwargs)}) beside
    their bf16 runs: top-10 overlap, Spearman's rho and the largest score
    delta, against the reference's bf16 contract (its grid.py:1061-1064:
    identical top-10, Spearman > 0.9999, max delta ~3e-4). A report: the
    result is printed, not gated."""
    import numpy as np
    from scipy.stats import spearmanr

    tw, ri = _real_size_grid()
    out = {}
    for name, (s_bf, kw) in bf16_runs.items():
        res, launches, wall, peak = _search(device, tw, ri, return_best_volume=False,
                                            compute_dtype="float32", **kw)
        s32 = res.scores
        if not np.all(np.isfinite(s32)):
            raise AssertionError(f"C10 {name}: non-finite float32 scores")
        top = lambda s: set(np.argsort(-s)[:10].tolist())  # noqa: E731
        overlap = len(top(s32) & top(s_bf))
        rho = float(spearmanr(s32, s_bf)[0])
        delta = float(np.abs(s32 - s_bf).max())
        met = overlap == 10 and rho > 0.9999 and delta <= 3e-4
        print(f"C10 [{name}]: float32 search {wall:.3f} s ({len(tw) / wall:.1f} candidates/s, "
              f"G={res.effective['groups_per_launch']}, peak {peak:.2f} GiB); against bf16: "
              f"top-10 overlap {overlap}/10, Spearman {rho:.6f}, max |delta| {delta:.3e}; "
              f"float32 top-1 {tuple(float(v) for v in res.top(1)[0][:2])}; the reference's "
              f"bf16 contract {'met' if met else 'NOT met'}", flush=True)
        out[name] = dict(overlap=overlap, spearman=rho, max_delta=delta, met=met,
                         wall=wall)
    return out


def _wide_rise_grid():
    """Phase 8's grid: phase 4's 179 twists over rises 2-10 A, 33 rises."""
    from helicon_tpu_torch.denovo3d import build_candidate_grid

    return build_candidate_grid(0.5, 45.0, 0.25, 2.0, 10.0, 0.25, handedness="left")


# phase 8 (a)'s rise buckets (rise range, candidates) at the default ratio 1.6
WIDE_BUCKETS = (((2.0, 3.0), 895), ((3.25, 5.0), 1432), ((5.25, 8.25), 2327),
                ((8.5, 10.0), 1253))
WIDE_RESCORED = 593


@contextlib.contextmanager
def _recorded_calls():
    """Every reconstruct_grid call the search drivers make (the bucketed
    search and the checkpoint call grid.reconstruct_grid by name): yields a
    list that gains, per call, its twists, rises, whether it solved a best
    volume, its wall seconds, its prepare_data seconds, B1's launches and
    its effective dict, and B2's launches."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve, grid, group_solve

    calls, inner, prep = [], grid.reconstruct_grid, grid.prepare_data
    prep_s = []

    def timed_prep(*args, **kw):
        t0 = time.perf_counter()
        out = prep(*args, **kw)
        torch.cuda.synchronize()
        prep_s.append(time.perf_counter() - t0)
        return out

    def b2():
        return sum(candidate_solve.launches.values())

    def recorded(image, apix, twists, rises, **kw):
        prep_s.clear()
        before, b2_before, t0 = group_solve.launches, b2(), time.perf_counter()
        res = inner(image, apix, twists, rises, **kw)
        torch.cuda.synchronize()
        calls.append(dict(twists=np.asarray(twists), rises=np.asarray(rises),
                          volume=bool(kw.get("return_best_volume")),
                          wall=time.perf_counter() - t0, prep_s=sum(prep_s),
                          launches=group_solve.launches - before, b2_launches=b2() - b2_before,
                          effective=res.effective, kw=kw))
        return res

    grid.reconstruct_grid, grid.prepare_data = recorded, timed_prep
    try:
        yield calls
    finally:
        grid.reconstruct_grid, grid.prepare_data = inner, prep


def _passes(calls) -> dict:
    """A bucketed search's calls by pass: the first pass (a bucket, several
    rises), the second (one rise a call), the winner (its best volume)."""
    import numpy as np

    out = {"first": [], "second": [], "winner": []}
    for c in calls:
        kind = ("winner" if c["volume"] else
                "first" if len(np.unique(c["rises"])) > 1 else "second")
        out[kind].append(c)
    return out


def _print_passes(label: str, passes) -> dict:
    """One line per pass: calls, candidates, wall, candidates/s, the prep /
    build / solve / score seconds, the scoring paths and B1 and B2
    launches; one line per first-pass bucket with its geometry. Returns the
    per-pass sums."""
    sums = {}
    for name, cs in passes.items():
        n = sum(len(c["twists"]) for c in cs)
        wall = sum(c["wall"] for c in cs)
        st = {k: sum(c["effective"][k] for c in cs) for k in ("build_s", "solve_s", "score_s")}
        sums[name] = dict(calls=len(cs), candidates=n, wall=wall,
                          prep_s=sum(c["prep_s"] for c in cs),
                          launches=sum(c["launches"] for c in cs),
                          b2_launches=sum(c["b2_launches"] for c in cs),
                          paths=sorted({c["effective"]["path"] for c in cs}), **st)
        print(f"{label} [{name} pass]: {len(cs)} calls ({'/'.join(sums[name]['paths'])}), "
              f"{n} candidates, {wall:.3f} s wall, "
              f"{n / max(wall, 1e-9):.1f} candidates/s, prep {sums[name]['prep_s']:.3f} s, "
              f"build {st['build_s']:.3f} s, solve {st['solve_s']:.3f} s, score "
              f"{st['score_s']:.3f} s, {sums[name]['launches']} B1 launches, "
              f"{sums[name]['b2_launches']} B2 launches", flush=True)
    for c in passes["first"]:
        e = c["effective"]
        print(f"{label} [bucket {float(c['rises'].min())}-{float(c['rises'].max())} A]: "
              f"{len(c['twists'])} candidates, d3={e['d3']} l3={e['l3']} C_u={e['C_u']} "
              f"R={e['R']} {e['n_groups']} groups, G={e['groups_per_launch']}, "
              f"{c['wall']:.3f} s, {c['launches']} B1 launches", flush=True)
    return sums


def phase_bucketed(device, label="phase 8 (a)", **prep) -> dict:
    """Phase 8 (a): the wide-rise search (5,907 candidates, four rise
    buckets, the second pass at per-candidate geometry, the winner's volume)
    with each pass's times, B1's and B2's launches and each bucket's
    geometry; every score finite, the buckets and the re-scored count as
    expected, B1 launched in every bucket, every second-pass call on the
    per-candidate path with B2 launched and no B1, the winner among the
    re-scored and its volume finite. ``prep`` goes to every call (the
    CLI's transpose / horizontalize)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import group_solve, reconstruct_grid

    tw, ri = _wide_rise_grid()
    img = np.load(AMYLOID)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group_solve.launches = 0
    t0 = time.perf_counter()
    with _recorded_calls() as calls:
        res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                               cg_iters=10, fista_iters=16, power_iters=2, device=device,
                               return_best_volume=True, **prep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = group_solve.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    passes = _passes(calls)
    sums = _print_passes(label, passes)
    print(f"{label}: {prep or 'no prep'}, {len(tw)} candidates in {res.effective['n_buckets']} buckets, "
          f"{wall:.3f} s wall incl. best volume, {len(tw) / wall:.1f} candidates/s, "
          f"{launches} B1 launches, peak {peak:.2f} GiB; top-5 {res.top(5).tolist()}",
          flush=True)
    buckets = [((float(c["rises"].min()), float(c["rises"].max())), len(c["twists"]))
               for c in passes["first"]]
    rescored = {(float(t), float(r)) for c in passes["second"]
                for t, r in zip(c["twists"], c["rises"])}
    bv = res.best_volume
    checks = {
        "every score finite": bool(np.all(np.isfinite(res.scores))),
        f"buckets {WIDE_BUCKETS}": tuple(buckets) == WIDE_BUCKETS,
        f"{WIDE_RESCORED} re-scored in at most 33 calls":
            sums["second"]["candidates"] == WIDE_RESCORED and len(passes["second"]) <= 33,
        "B1 launched in every bucket": all(c["launches"] > 0 for c in passes["first"]),
        "every second-pass call per candidate, B2 launched, no B1": all(
            c["effective"]["path"] == "percand" and c["b2_launches"] > 0 and c["launches"] == 0
            for c in passes["second"]),
        "winner among the re-scored":
            (float(tw[res.best_index]), float(ri[res.best_index])) in rescored,
        "best volume finite": bv is not None and bool(np.all(np.isfinite(bv))),
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"{label}: failed: {what}")
    print(f"{label}: gates met: {', '.join(checks)}", flush=True)
    return dict(res=res, calls=calls, sums=sums, launches=launches, wall=wall, peak=peak)


def phase_r1(device, bucketed) -> dict:
    """Phase 8 (b): B1 at R = 1, the route HELICON_GRID_GROUPED=1 forces on
    a grid of one candidate per twist (the main path sends such grids per
    candidate since PR 8), against its plain version on the same card
    tensors: the largest second-pass call of (a) scored through the
    grouped scorer with each solve (phase 2's bf16 gate: scores within
    1e-3), then one launch's solve alone timed with both, beside its
    bound."""
    import os

    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import grid, group_solve as gs, reconstruct_grid

    second = [c for c in bucketed["calls"] if not c["volume"] and len(np.unique(c["rises"])) == 1]
    call = max(second, key=lambda c: len(c["twists"]))
    captured, scorer = {}, grid._grouped_scoring

    def capture(*args, **kw):
        captured.update(args=args, kw=kw)
        return scorer(*args, **kw)

    grid._grouped_scoring = capture
    os.environ["HELICON_GRID_GROUPED"] = "1"
    try:
        reconstruct_grid(np.load(AMYLOID), apix=2.0, twists=call["twists"], rises=call["rises"],
                         tube_diameter=110.0, cg_iters=10, fista_iters=16, power_iters=2,
                         device=device, return_best_volume=False)
    finally:
        grid._grouped_scoring = scorer
        del os.environ["HELICON_GRID_GROUPED"]
    inputs = []

    def kernel(inp, *a, **k):
        inputs.append(inp)
        return gs.solve_group(inp, *a, **k)

    run = grid._tf32_off(scorer)
    s_k, eff = run(*captured["args"], **dict(captured["kw"], solve=kernel))
    s_p, _ = run(*captured["args"], **dict(captured["kw"], solve=gs.solve_group_reference))
    err = float(np.abs(s_k - s_p).max())
    inp = inputs[0]
    G, R, C_u, O, l3, d3sq = inp.shape
    ms_k = _time_ms(lambda: gs.solve_group(inp, *ITERS), 3)
    ms_p = _time_ms(lambda: gs.solve_group_reference(inp, *ITERS), 2)
    bound_ms, bound_by = _bound(*_group_work(inp, ITERS), bf16=inp.a_top.dtype == torch.bfloat16)
    print(f"phase 8 (b) [HELICON_GRID_GROUPED=1: R={R}, rise {float(call['rises'][0])} A, G={G} "
          f"groups, d3={eff['d3']} l3={l3} C_u={C_u} O={O}, {eff['compute_dtype']}]: score abs "
          f"err {err:.3e} (limit 1e-3), kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms per call, "
          f"bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    if R != 1 or not np.all(np.isfinite(s_k)) or not (err <= 1e-3):
        raise AssertionError(f"phase 8 (b): B1 at R = {R} differs from plain by {err}")
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
                groups=(G, R, C_u, O))


def phase_incremental(device, phase4_scores) -> dict:
    """Phase 8 (c): phase 4's search as the web app calls it
    (progress_callback and should_abort, no batch_size): launches of at
    most the reference's automatic batch of candidates, one progress call
    per launch, done rising to 2,327, the scores within 1e-3 of phase 4's;
    its wall beside phase 4's call (memory-sized launches) run just
    before. Then an abort after the first launch: the unscored candidates
    -inf, no best volume."""
    import numpy as np

    tw, ri = _real_size_grid()
    _, _, wall_one, _ = _search(device, tw, ri, return_best_volume=True)
    seen = []
    res, launches, wall, _ = _search(device, tw, ri, return_best_volume=True,
                                     progress_callback=lambda d, n, s: seen.append(d),
                                     should_abort=lambda: False)
    e = res.effective
    n_launch = -(-e["n_groups"] // e["groups_per_launch"])
    delta = float(np.abs(res.scores - phase4_scores).max())
    print(f"phase 8 (c) [the web app's call]: {e['launch_candidates']} candidates a launch "
          f"(the reference's automatic batch), R={e['R']} G={e['groups_per_launch']} of "
          f"{e['n_groups']} groups, {n_launch} launches, {len(seen)} progress calls (first "
          f"{seen[:3]}, last {seen[-1]}), {wall:.3f} s wall ({len(tw) / wall:.1f} candidates/s; "
          f"phase 4's call just before {wall_one:.3f} s, {len(tw) / wall_one:.1f}/s), build "
          f"{e['build_s']:.3f} s, solve {e['solve_s']:.3f} s, {launches} B1 launches; max "
          f"|score - phase 4's| {delta:.3e} (limit 1e-3)", flush=True)
    if not (len(seen) == n_launch and seen == sorted(seen) and seen[-1] == len(tw)
            and e["groups_per_launch"] == max(1, e["launch_candidates"] // e["R"])
            and delta <= 1e-3):
        raise AssertionError("phase 8 (c): progress protocol or scores off")
    polls = []
    part, _, wall_abort, _ = _search(device, tw, ri, return_best_volume=True,
                                     should_abort=lambda: polls.append(1) or len(polls) > 1)
    scored = int(np.isfinite(part.scores).sum())
    print(f"phase 8 (c) [abort after the first launch]: {scored} scored, "
          f"{int(np.isneginf(part.scores).sum())} at -inf, best volume "
          f"{'none' if part.best_volume is None else 'solved'}, {wall_abort:.3f} s", flush=True)
    if not (scored == e["groups_per_launch"] * e["R"]
            and np.isneginf(part.scores).sum() == len(tw) - scored
            and part.best_volume is None):
        raise AssertionError("phase 8 (c): the aborted search is not partial or solved a volume")
    return dict(launches=n_launch, wall=wall, wall_one=wall_one)


def phase_checkpointed(device, bucketed) -> dict:
    """Phase 8 (d): (a)'s grid through reconstruct_grid_checkpointed(chunk
    1024) with its shard under build/, stopped after 2 chunks and resumed:
    the resumed run scores only the missing chunks, its scores lie within
    1e-3 of (a)'s and its winner is (a)'s."""
    import numpy as np

    from helicon_tpu_torch.denovo3d import reconstruct_grid_checkpointed
    from helicon_tpu_torch.denovo3d.grid import global_rise_buckets

    tw, ri = _wide_rise_grid()
    shard = ROOT / "build" / "smoke_checkpoint.npz"
    shard.parent.mkdir(exist_ok=True)
    shard.unlink(missing_ok=True)
    kw = dict(apix=2.0, twists=tw, rises=ri, checkpoint_path=str(shard), chunk=1024,
              tube_diameter=110.0, cg_iters=10, fista_iters=16, power_iters=2, device=device)
    img = np.load(AMYLOID)
    n_chunks = sum(-(-len(b) // 1024) for b in global_rise_buckets(ri, 1.6))
    polls = []
    t0 = time.perf_counter()
    part = reconstruct_grid_checkpointed(img, should_abort=lambda: polls.append(1) or len(polls) > 2,
                                         **kw)
    t1 = time.perf_counter()
    res = reconstruct_grid_checkpointed(img, **kw)
    t2 = time.perf_counter()
    ref = bucketed["res"]
    delta = float(np.abs(res.scores - ref.scores).max())
    print(f"phase 8 (d): stopped after {part.effective['chunks_run']} of {n_chunks} chunks "
          f"({int(np.isfinite(part.scores).sum())} scored, {t1 - t0:.3f} s), resumed with "
          f"{res.effective['chunks_run']} chunks and the merge ({t2 - t1:.3f} s); max |score - "
          f"(a)'s| {delta:.3e} (limit 1e-3); winner {tuple(res.top(1)[0][:2].tolist())}, (a)'s "
          f"({float(tw[ref.best_index])}, {float(ri[ref.best_index])})", flush=True)
    if not (part.effective["chunks_run"] == 2 and res.effective["chunks_run"] == n_chunks - 2
            and delta <= 1e-3 and res.best_index == ref.best_index
            and res.best_volume is not None):
        raise AssertionError("phase 8 (d): the resumed checkpointed search is off")
    return dict(wall_stopped=t1 - t0, wall_resumed=t2 - t1, delta=delta)


def phase_prep(device) -> dict:
    """Phase 8 (e): the amyloid transposed and rotated by 3 deg, through
    prepare_data(transpose=-1, horizontalize=1, low_pass=10) on the card
    and on the CPU: the recovered angles within 0.05 deg, and the card's
    image within 1e-4 (relative to its max) of the CPU chain rotated by the
    card's angle and shift (Nelder-Mead follows float values, so the two
    searches may stop apart within their xtol); each denoiser on the card
    against the CPU within 1e-4 relative; then the golden grid with the
    CLI's prep defaults on that image."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core.denoise import denoise_image
    from helicon_tpu_torch.core.transforms import rotate_shift_image
    from helicon_tpu_torch.denovo3d import reconstruct_grid
    from helicon_tpu_torch.denovo3d.pipeline import prepare_data
    from helicon_tpu_torch.helix.orient import auto_horizontalize

    amy = torch.from_numpy(np.load(AMYLOID).astype(np.float32))
    img = rotate_shift_image(amy.T.contiguous().to(device), angle=3.0).cpu().numpy()
    kw = dict(transpose=-1, horizontalize=1, low_pass=10.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = prepare_data(img, 2.0, device=device, **kw)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    lowp = {d: prepare_data(img, 2.0, transpose=-1, low_pass=10.0, device=d)
            for d in (device, "cpu")}
    (_, th_c, sy_c), (_, th_h, sy_h) = (auto_horizontalize(lowp[d], refine=True)
                                        for d in (device, "cpu"))
    host_at_card = rotate_shift_image(lowp["cpu"], angle=th_c, post_shift=(sy_c, 0), order=3)
    rel = float((card.cpu() - host_at_card).abs().max() / host_at_card.abs().max())
    print(f"phase 8 (e): prepare_data {kw} on the card {prep_s:.3f} s; recovered angle "
          f"{th_c:.4f} deg shift {sy_c:.4f} px (CPU {th_h:.4f} deg, {sy_h:.4f} px); image "
          f"against the CPU chain at the card's angle: {rel:.3e} of max (limit 1e-4)", flush=True)
    if not (abs(th_c - th_h) <= 0.05 and rel <= 1e-4):
        raise AssertionError(f"phase 8 (e): the card's prep is off the CPU's ({th_c}, {th_h}, {rel})")
    errs = {}
    for method in ("nl_mean", "tv", "wavelet"):
        a = denoise_image(amy.to(device), method).cpu()
        b = denoise_image(amy, method)
        errs[method] = float((a - b).abs().max() / b.abs().max())
    print(f"phase 8 (e): denoisers, card against CPU (of max; limit 1e-4): {errs}", flush=True)
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"phase 8 (e): a denoiser is off on the card: {errs}")
    tw, ri = _golden_grid()
    res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0, cg_iters=10,
                           fista_iters=16, power_iters=2, return_best_volume=False,
                           transpose=-1, horizontalize=1, device=device)
    print(f"phase 8 (e): golden grid on the transposed, rotated image with transpose=-1, "
          f"horizontalize=1: top-5 {res.top(5).tolist()} (the golden's top-1 (2.0, 4.75))",
          flush=True)
    if not np.all(np.isfinite(res.scores)):
        raise AssertionError("phase 8 (e): non-finite scores")
    return dict(prep_s=prep_s, angle=th_c, shift=sy_c, rel=rel, denoise=errs)


def phase_fsc1(device, solve_launches: int) -> dict:
    """Phase 8 (f): phase 4's search with fsc_test=1 (JAX's random pixel
    split): finite scores, and three B1 solves a launch, each of
    ``solve_launches`` kernel launches (phase 4's one-launch count)."""
    import math

    import torch

    tw, ri = _real_size_grid()
    torch.cuda.empty_cache()
    res, launches, wall, peak = _search(device, tw, ri, return_best_volume=True, fsc_test=1)
    e = res.effective
    want = 3 * solve_launches * math.ceil(e["n_groups"] / e["groups_per_launch"])
    print(f"phase 8 (f) [fsc_test=1]: {wall:.3f} s wall, {len(tw) / wall:.1f} candidates/s, "
          f"G={e['groups_per_launch']}, {launches} B1 launches (three solves of "
          f"{solve_launches} a launch: {want}), peak {peak:.2f} GiB; top-1 "
          f"{tuple(float(v) for v in res.top(1)[0])}", flush=True)
    _check_search(res, launches, "phase 8 (f)")
    if launches != want:
        raise AssertionError(f"phase 8 (f): {launches} B1 launches, not {want}")
    return dict(launches=launches, wall=wall)


# ---------------------------------------------------------------------------
# phase 9: the per-candidate path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _b2_solve(plain: bool = False, record=None):
    """B2's solve as the per-candidate path calls it, its plain version
    with ``plain`` (on the same card tensors), every CandidateInputs it is
    given appended to ``record``."""
    from helicon_tpu_torch.denovo3d import candidate_solve as cs

    kernel = cs.solve_candidate_kernel

    def solve(inp, *iters):
        if record is not None:
            record.append(inp)
        return (cs.solve_candidate_reference if plain else kernel)(inp, *iters)

    cs.solve_candidate_kernel = solve
    try:
        yield
    finally:
        cs.solve_candidate_kernel = kernel


def _b2_count() -> int:
    from helicon_tpu_torch.denovo3d import candidate_solve as cs

    return sum(cs.launches.values())


def phase_second_pass(device, bucketed) -> dict:
    """Phase 9 (a): the largest second-pass call of phase 8 (a) again, on
    the per-candidate path with B2 and with B2's plain version on the same
    card tensors: bfloat16 scores within 1e-3, and the call in float32
    within 1e-4; then one of its B2 launches (bfloat16) timed with both,
    beside its bound."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve as cs, reconstruct_grid

    second = [c for c in bucketed["calls"] if not c["volume"] and len(np.unique(c["rises"])) == 1]
    call = max(second, key=lambda c: len(c["twists"]))
    img = np.load(AMYLOID)
    out, captured = {}, []
    for dtype, tol in (("auto", 1e-3), ("float32", 1e-4)):
        s = {}
        for plain in (False, True):
            with _b2_solve(plain, captured if dtype == "auto" and not plain else None):
                res = reconstruct_grid(img, apix=2.0, twists=call["twists"],
                                       rises=call["rises"], tube_diameter=110.0, cg_iters=10,
                                       fista_iters=16, power_iters=2, compute_dtype=dtype,
                                       device=device, return_best_volume=False)
            s[plain] = res.scores
        err = float(np.abs(s[False] - s[True]).max())
        e = res.effective
        print(f"phase 9 (a) [second-pass call at rise {float(call['rises'][0])} A, "
              f"{len(call['twists'])} candidates, {e['compute_dtype']}, d3={e['d3']} "
              f"l3={e['l3']} C={e['n_copies']} O={e['n_ops']}, k={e['batch_size']}]: B2 "
              f"against plain, score abs err {err:.3e} (limit {tol:g})", flush=True)
        if e["path"] != "percand" or not np.all(np.isfinite(s[False])) or not (err <= tol):
            raise AssertionError(f"phase 9 (a): B2 differs from plain by {err} ({dtype})")
        out[e["compute_dtype"]] = err
    inp = captured[0]
    ms_k = _time_ms(lambda: cs.solve_candidate_kernel(inp, *ITERS), 5)
    ms_p = _time_ms(lambda: cs.solve_candidate_reference(inp, *ITERS), 3)
    bf16 = inp.a_top.dtype == torch.bfloat16
    bound_ms, bound_by = _bound(*_single_work(inp), bf16=bf16)
    k, C, O, l3, d3sq = inp.shape
    print(f"phase 9 (a) [one B2 launch: k={k} C={C} O={O} l3={l3} d3^2={d3sq}, "
          f"{inp.a_top.dtype}]: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=out["bfloat16"], float32_err=out["float32"], ms=ms_k,
                plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by, shape=(k, C, O, l3, d3sq))


def _golden_search(device, tw, ri, **kw):
    """The golden grid's reconstruct_grid on the amyloid (the bench's
    iterations), with B2's launches counted: (result, B2 launches, wall s,
    peak GiB)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import reconstruct_grid

    img = np.load(AMYLOID)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, t0 = _b2_count(), time.perf_counter()
    res = reconstruct_grid(img, apix=2.0, twists=tw, rises=ri, tube_diameter=110.0,
                           cg_iters=10, fista_iters=16, power_iters=2, device=device, **kw)
    torch.cuda.synchronize()
    return (res, _b2_count() - before, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def _print_golden(label, res, b2, wall, peak, n):
    """A per-candidate golden search's line; fails unless it went per
    candidate with finite scores and volume."""
    import numpy as np

    e = res.effective
    print(f"{label}: {n} candidates on the {e['path']} path ({e['compute_dtype']}, k="
          f"{e['batch_size']}, d3={e['d3']} l3={e['l3']} C={e['n_copies']} O={e['n_ops']}), "
          f"{wall:.3f} s wall incl. best volume, {n / wall:.2f} candidates/s, build "
          f"{e['build_s']:.3f} s, solve {e['solve_s']:.3f} s, score {e['score_s']:.3f} s, "
          f"{b2} B2 launches, peak {peak:.2f} GiB; top-3 {res.top(3).tolist()}", flush=True)
    bv = res.best_volume
    if (e["path"] != "percand" or not np.all(np.isfinite(res.scores)) or bv is None
            or not np.all(np.isfinite(bv))):
        raise AssertionError(f"{label}: not per candidate, or non-finite scores or volume")


def phase_tilted(device) -> dict:
    """Phase 9 (b): the golden grid at tilt 3 deg on the gather projector
    (wall, candidates/s, peak memory, finite scores); the gather P and PT
    of its best candidate per application (CUDA events); then four golden
    candidates at tilt 0, float32, on the gather projector against the
    separable path (B2): scores within 1e-4."""
    import os

    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import grid, reconstruct_grid
    from helicon_tpu_torch.denovo3d.projector import build_problem

    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    tw, ri = _golden_grid()
    _zero(gk.launches)
    res, b2, wall, peak = _golden_search(device, tw, ri, tilt=3.0, return_best_volume=True)
    _print_golden("phase 9 (b) [tilt 3 deg]", res, b2, wall, peak, len(tw))
    out = dict(wall=wall, rate=len(tw) / wall, peak=peak, b2_launches=b2,
               solve_s=res.effective["solve_s"], gather_launches=dict(gk.launches))
    # the best candidate's gather operators at the golden geometry, tilt 3 deg
    geom, e, bi = res.geom, res.effective, res.best_index
    rp = (ri / res.target_apix3d)[bi : bi + 1]
    tabs = grid._candidate_tables(geom, tw[bi : bi + 1], rp, e["n_copies"], e["n_pairs"],
                                  e["n_ops"])
    ch, cc, cv, phc, pv = (t[0] for t in tabs[:5])
    ops = build_problem(geom, np.zeros((geom.d2, geom.l2), np.float32), tw[bi], rp[0], ch, cc,
                        cv, phc, pv, 3.0, 0.0, 0.0, "nn", geom.cylindrical_mask(),
                        geom.cell_valid_mask(), device=device)
    x = torch.rand(geom.volume_shape, device=device) * ops["mask"]
    r = torch.rand(ops["row_valid"].shape, device=device)
    out["golden"] = (geom, float(tw[bi]), float(rp[0]), (ch, cc, cv), (phc, pv))
    out["grid"] = (geom, tw, ri / res.target_apix3d, e["n_copies"], e["n_pairs"], e["n_ops"])
    out["P_ms"] = _time_ms(lambda: ops["P"](x), 5)
    out["PT_ms"] = _time_ms(lambda: ops["PT"](r), 5)
    n = int(cv.sum()) * geom.l2 * geom.d2 * geom.d2
    print(f"phase 9 (b) [gather projector (K1 / K2), tilt 3 deg, C={len(ch)} copies, {n} "
          f"samples]: P {out['P_ms']:.3f} ms, PT {out['PT_ms']:.3f} ms per application",
          flush=True)
    # tilt 0: the gather projector against the separable path, float32
    sub = np.float32([2.0, 2.0, 2.25, 2.25]), np.float32([4.75, 4.9, 4.75, 4.9])
    solve = grid.solve_candidates
    s = {}
    os.environ["HELICON_GRID_GROUPED"] = "0"
    try:
        for gather in (False, True):
            if gather:
                grid.solve_candidates = lambda geom, cfg, *a, **k: solve(
                    geom, cfg._replace(separable=False), *a, **k)
            s[gather] = reconstruct_grid(
                np.load(AMYLOID), apix=2.0, twists=sub[0], rises=sub[1], tube_diameter=110.0,
                cg_iters=10, fista_iters=16, power_iters=2, compute_dtype="float32",
                device=device, return_best_volume=False).scores
    finally:
        grid.solve_candidates = solve
        del os.environ["HELICON_GRID_GROUPED"]
    err = float(np.abs(s[True] - s[False]).max())
    print(f"phase 9 (b) [tilt 0, float32, 4 golden candidates]: gather projector against the "
          f"separable path (B2), score abs err {err:.3e} (limit 1e-4)", flush=True)
    if not (err <= 1e-4):
        raise AssertionError(f"phase 9 (b): the gather path differs by {err} at tilt 0")
    out["tilt0_err"] = err
    return out


@contextlib.contextmanager
def _b2_matvec(plain: bool = False, record=None):
    """B2's matvec entry as ard's EM loop calls it, its plain version with
    ``plain`` (on the same card tensors), the first (CandidateInputs, v)
    it is given with a nonzero v appended to ``record``."""
    from helicon_tpu_torch.denovo3d import candidate_solve as cs

    kernel = cs.candidate_matvec

    def matvec(inp, v):
        if record is not None and not record and bool(v.any()):
            record.append((inp, v.clone()))
        return (cs.candidate_matvec_reference if plain else kernel)(inp, v)

    cs.candidate_matvec = matvec
    try:
        yield
    finally:
        cs.candidate_matvec = kernel


def _kernel_vs_plain_search(device, label, swap, **kw):
    """The golden grid's per-candidate search with B2's kernels and with
    their plain versions (``swap(plain, record)``) on the same card
    tensors, in bfloat16 (scores within 1e-3) and in float32 (1e-4); the
    bf16 kernel run counted and timed as a search. Returns (the bf16
    kernel run's (result, launches, wall, peak), {dtype: max score error},
    the bf16 kernel run's recorded calls)."""
    import numpy as np

    tw, ri = _golden_grid()
    errs, record, run = {}, [], None
    for dtype, tol in (("auto", 1e-3), ("float32", 1e-4)):
        s = {}
        for plain in (False, True):
            rec = record if dtype == "auto" and not plain else None
            with swap(plain, rec):
                got = _golden_search(device, tw, ri, compute_dtype=dtype,
                                     return_best_volume=not plain, **kw)
            if rec is not None:
                run = got
            s[plain] = got[0].scores
        e = got[0].effective
        err = float(np.abs(s[False] - s[True]).max())
        print(f"{label} [{e['compute_dtype']}, k={e['batch_size']}]: B2 against plain on the "
              f"search's own inputs, score abs err {err:.3e} (limit {tol:g})", flush=True)
        if e["path"] != "percand" or not np.all(np.isfinite(s[False])) or not (err <= tol):
            raise AssertionError(f"{label}: B2 differs from plain by {err} ({e['compute_dtype']})")
        errs[e["compute_dtype"]] = err
    return run, errs, record


def phase_ard(device, single) -> dict:
    """Phase 9 (c): ard on the golden grid (B2's matvec entry under the
    torch EM loop), with the matvec entry and with its plain version on
    the same card tensors (bf16 scores within 1e-3, float32 1e-4); one of
    the search's bf16 matvecs timed with both beside its bound; then the
    entry against plain on phase 5's float32 nn inputs (k = 8): relative
    1e-5, timed likewise."""
    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve as cs

    (res, b2, wall, peak), errs, record = _kernel_vs_plain_search(
        device, "phase 9 (c) [ard]", _b2_matvec, algorithm=dict(model="ard"))
    _print_golden("phase 9 (c) [ard]", res, b2, wall, peak, len(res.scores))
    out = dict(wall=wall, launches=b2, max_abs_err=errs["bfloat16"], float32_err=errs["float32"])

    def timed(inp, v, label):
        got, want = cs.candidate_matvec(inp, v), cs.candidate_matvec_reference(inp, v)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        ms_k = _time_ms(lambda: cs.candidate_matvec(inp, v), 20)
        ms_p = _time_ms(lambda: cs.candidate_matvec_reference(inp, v), 20)
        bound_ms, bound_by = _bound(*_single_work(inp, nm=1),
                                    bf16=inp.a_top.dtype == torch.bfloat16)
        k, C, O, l3, d3sq = inp.shape
        print(f"phase 9 (c) [{label}: the matvec entry, {inp.a_top.dtype}, k={k} C={C} O={O} "
              f"l3={l3} d3^2={d3sq}]: rel err {rel:.3e}, kernel {ms_k:.3f} ms, plain "
              f"{ms_p:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        return dict(max_abs_err=float((got - want).abs().max()), rel_err=rel, ms=ms_k,
                    plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by)

    out["search_matvec"] = timed(*record[0], "one of the search's matvecs")
    inp = single["inputs"][("solve_candidate", "nn", "float32")]
    extra = timed(inp, torch.rand(inp.rhs.shape, device=device) * inp.mask,
                  "phase 5's inputs")
    if not (extra["rel_err"] <= 1e-5):
        raise AssertionError(f"phase 9 (c): the matvec entry differs from plain by "
                             f"{extra['rel_err']} on phase 5's inputs")
    out["k8"] = extra
    return out


def phase_fsc_regularized(device, single) -> dict:
    """Phase 9 (d): elasticnet with fsc_test=2 on the golden grid (the
    reference sends it per candidate: three B2 solves a launch, the halves
    on j-dependent z-Grams), with B2 and with its plain version on the
    same card tensors (bf16 scores within 1e-3, float32 1e-4); one of the
    search's bf16 half solves timed with both beside its bound; then B2 on
    an fsc half's j-dependent z-Gram against plain on phase 5's float32 nn
    inputs (k = 8): x within 1e-3 relative, timed likewise."""
    import dataclasses as dc

    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve as cs
    from helicon_tpu_torch.denovo3d.solver import _pid_split_masks

    (res, b2, wall, peak), errs, record = _kernel_vs_plain_search(
        device, "phase 9 (d) [elasticnet, fsc_test=2]", _b2_solve,
        algorithm=dict(model="elasticnet"), fsc_test=2)
    _print_golden("phase 9 (d) [elasticnet, fsc_test=2]", res, b2, wall, peak, len(res.scores))
    out = dict(wall=wall, launches=b2, max_abs_err=errs["bfloat16"], float32_err=errs["float32"])

    def timed(inp, label):
        x_k = cs.solve_candidate_kernel(inp, *ITERS)
        x_p = cs.solve_candidate_reference(inp, *ITERS)
        torch.cuda.synchronize()
        rel = float((x_k - x_p).abs().max() / x_p.abs().max().clamp_min(1e-30))
        ms_k = _time_ms(lambda: cs.solve_candidate_kernel(inp, *ITERS), 3)
        ms_p = _time_ms(lambda: cs.solve_candidate_reference(inp, *ITERS), 2)
        bound_ms, bound_by = _bound(*_single_work(inp), bf16=inp.a_top.dtype == torch.bfloat16)
        k, C, O, l3, d3sq = inp.shape
        print(f"phase 9 (d) [{label}: B2 on an fsc half's j-dependent z-Gram "
              f"{tuple(inp.gz.shape)}, {inp.a_top.dtype}, k={k} O={O}]: x rel err {rel:.3e}, "
              f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})",
              flush=True)
        return dict(max_abs_err=float((x_k - x_p).abs().max()), rel_err=rel, ms=ms_k,
                    plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
                    finite=bool(torch.isfinite(x_k).all()))

    half = next(i for i in record if i.gz.dim() == 5)
    out["search_half"] = timed(half, "one of the search's half solves")
    inp = single["inputs"][("solve_candidate", "nn", "float32")]
    geom = single["cands"][0]["geom"]
    m1 = torch.as_tensor(_pid_split_masks(geom, 2)[0][0], device=device)
    mz = torch.stack([c["nn"]["ops"]["factors"]["Mz"].float() for c in single["cands"]])
    gz = torch.einsum("kcim,kcin,ij->kcmnj", mz, mz, m1).contiguous()
    rhs = torch.stack([
        (c["nn"]["ops"]["PT"](c["nn"]["ops"]["b"][None] * c["nn"]["ops"]["row_valid"].float()
                              * m1) * c["nn"]["ops"]["mask"].float()).reshape(inp.rhs.shape[1:])
        for c in single["cands"]]).contiguous()
    extra = timed(dc.replace(inp, gz=gz, rhs=rhs), "phase 5's inputs")
    if not (extra["rel_err"] <= 1e-3) or not extra["finite"]:
        raise AssertionError(f"phase 9 (d): B2's half solve differs from plain by "
                             f"{extra['rel_err']} on phase 5's inputs")
    out["k8"] = extra
    return out


# ---------------------------------------------------------------------------
# phase 10: pose refinement on the gather kernels K1-K4
# ---------------------------------------------------------------------------

# float operations a sample. Every sample of a ray the kernels take (K1 and
# K2: a ray of the list, which holds a valid sample; K3: a ray it does not
# prune, a populated copy slot with some sample inside the volume's z
# range): its coordinates (three 3-term dot products, the copy's turn and
# shifts: 25).
# Each valid sample besides: nn K1 one add (the ray's sum), K2 three (the
# term's scaling and rounding to an integer, the add); linear the fractions
# and their complements (6) and the eight weights (16), then K1 the
# weighted sum and the ray's add (16), K2 the eight products, scalings,
# roundings and adds (32), K3 the weighted sum (16), the trilinear gradient
# (30), the coordinates' derivatives by tilt and psi (30) and the three
# dot products with the gradient (30)
COORD_OPS = 25
VALID_OPS = {("project", "nn"): 1, ("backproject", "nn"): 3, ("project", "linear"): 38,
             ("backproject", "linear"): 54, ("jacobian", "linear"): 128}
# K4, a (pair, voxel) item: every item in the mask with a populated slot
# its two ops' coordinates (14); each valid one besides: nn the difference
# and two terms' scaling, rounding and add (7); linear the two samples'
# fractions, weights and weighted sums (2 x 37), the difference, and
# sixteen terms' products, scalings, roundings and adds (64)
SYM_COORD_OPS = 14
SYM_VALID_OPS = {"nn": 7, "linear": 139}
# phase 9 (b)'s wall on the torch gather projector the kernels replaced
# (PERF.md section 5)
TORCH_GATHER_TILT3_WALL = 41.8
# the CLI's --refineTiltPsiDy 5 5 2 (refineTopK 1, refineMode topk)
REFINE_RANGE = dict(tilt=5.0, psi=5.0, dy=2.0)


def _zero(counts: dict) -> None:
    for k in counts:
        counts[k] = 0


@contextlib.contextmanager
def _plain_gather():
    """K1-K4's wrappers swapped for their plain versions (on the same CUDA
    tensors) for the duration."""
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    names = ("gather_project", "gather_backproject", "pose_jacobian", "sym_normal")
    saved = [getattr(gk, n) for n in names]
    for n in names:
        setattr(gk, n, getattr(gk, n + "_reference"))
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(gk, n, f)


def _samples(tab):
    """Candidate 0 of tab: (samples of the populated copy slots, samples of
    the rays the kernels do not prune by z, valid samples, the plain
    version's coordinates (Z, Y, X) of the populated slots' samples)."""
    import torch

    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    keep = tab.cvf[0] > 0
    top = tab.l3 - (2 if tab.linear else 1)
    n_live = n_valid = 0
    coords = []
    for sl, zyx, _, valid in gk._chunks(tab, 0, tab.sampler()):
        k = keep[sl]
        z = torch.floor(zyx[0]) if tab.linear else torch.round(zyx[0])
        n_live += int(((z >= 0) & (z <= top)).any(dim=-1)[k].sum()) * tab.d2
        n_valid += int(valid[k].sum())
        coords.append(torch.stack(zyx, dim=-1)[k])
    coords = torch.cat(coords)
    n_all = coords.shape[0] * coords.shape[1] * coords.shape[2] * coords.shape[3]
    return n_all, n_live, n_valid, coords


def _sym_items(st):
    """Candidate 0 of the symmetry tables st: (its (pair, voxel) items in
    the mask with a populated slot, the valid ones)."""
    keep = (st.mask.reshape(st.l3, st.d3, st.d3) > 0.5)[None] & (st.pv[0] > 0.5)[:, None,
                                                                                None, None]
    if st.keep is not None:
        keep = keep & st.keep[0]
    return int(keep.sum()), int(st.taps()[2][0].sum())


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _hold_gather(label, tab, st, x, r, b, card, timed=False) -> dict:
    """K1, K2, K4 and, on linear tables with derivatives, K3 against their
    plain versions on the same card tensors (tables of one candidate):
    P within 1e-5 of its max and row_valid equal; P, PT and ST(S(x)) bit
    for bit (the plain P sums a ray in the kernel's order, PT and ST(S(x))
    sum exactly), K1 and K2 both testing every ray and on the list of live
    rays the projector builds; J^T J and J^T r within 1e-4 relative. timed:
    each kernel (K1, K2 on the list) and its plain version timed by CUDA
    events beside its bound, and the yardsticks: for P
    torch.nn.functional.grid_sample (5-D, nearest / bilinear, zero padding)
    on the same samples plus the sum along the ray; for nn PT one
    index_add_ of the same valid samples' indices. Returns the rows by
    (kernel, interpolation)."""
    import torch
    import torch.nn.functional as F

    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    interp = "linear" if tab.linear else "nn"
    rows = {}
    # K1
    p_k, rv_k = gk.gather_project(tab, x, row_valid=True)
    p_p, rv_p = gk.gather_project_reference(tab, x, row_valid=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    listed = gk.with_live_rays(tab, rv_k)
    list_ms = (time.perf_counter() - t0) * 1e3
    p_l = gk.gather_project(listed, x)
    torch.cuda.synchronize()
    err_p, rv_same = _rel(p_k, p_p), bool((rv_k == rv_p).all())
    p_same = bool(torch.equal(p_k, p_p) and torch.equal(p_l, p_p))
    row = dict(max_abs_err=float(max((p_k - p_p).abs().max(), (p_l - p_p).abs().max())),
               rel_err=err_p, equal=p_same, live_rays=listed.n_max, list_build_ms=list_ms)
    if not (err_p <= 1e-5 and rv_same and p_same):
        raise AssertionError(f"{label}: K1 differs from plain ({err_p}, {rv_same}, {p_same})")
    # K2
    pt_k, pt_p = gk.gather_backproject(tab, r), gk.gather_backproject_reference(tab, r)
    pt_l = gk.gather_backproject(listed, r)
    torch.cuda.synchronize()
    pt_same = bool(torch.equal(pt_k, pt_p) and torch.equal(pt_l, pt_p))
    rows[("backproject", interp)] = dict(max_abs_err=float((pt_k - pt_p).abs().max()),
                                         equal=pt_same)
    if not pt_same:
        raise AssertionError(f"{label}: K2 differs from plain by "
                             f"{float((pt_k - pt_p).abs().max())}")
    # K4
    sts_k, sts_p = gk.sym_normal(st, x), gk.sym_normal_reference(st, x)
    torch.cuda.synchronize()
    sts_same = bool(torch.equal(sts_k, sts_p))
    rows[("sym_normal", interp)] = dict(max_abs_err=float((sts_k - sts_p).abs().max()),
                                        equal=sts_same)
    if not sts_same:
        raise AssertionError(f"{label}: K4 differs from plain by "
                             f"{float((sts_k - sts_p).abs().max())}")
    # K3
    errs = None
    if tab.linear and tab.dR is not None:
        jk, jp = gk.pose_jacobian(tab, x, b), gk.pose_jacobian_reference(tab, x, b)
        torch.cuda.synchronize()
        errs = [_rel(a, c) for a, c in zip(jk, jp)]
        rows[("jacobian", interp)] = dict(
            max_abs_err=float(max((a - c).abs().max() for a, c in zip(jk, jp))),
            rel_err_JtJ=errs[0], rel_err_Jtr=errs[1], rel_err_rtr=errs[2])
        if not (errs[0] <= 1e-4 and errs[1] <= 1e-4):
            raise AssertionError(f"{label}: K3 differs from plain ({errs})")
    rows[("project", interp)] = row
    k3 = "" if errs is None else (f"; K3 J^T J {errs[0]:.3e}, J^T r {errs[1]:.3e}, r^T r "
                                  f"{errs[2]:.3e} (limit 1e-4)")
    print(f"{label}: K1 rel err {err_p:.3e} (limit 1e-5), row_valid "
          f"{'equal' if rv_same else 'DIFFERS'}; K1, K2 (every ray tested, and on the list of "
          f"{listed.n_max} live rays, built in {list_ms:.3f} ms) and K4 equal to plain bit for "
          f"bit{k3}; {card}", flush=True)
    if not timed:
        return rows

    n_all, n_live, n_valid, zyx = _samples(tab)
    # K1 and K2 compute the samples of the listed rays, K3 of the unpruned
    n_listed = listed.n_max * tab.d2
    aux_bytes = _nbytes(tab.aux)
    row.update(samples=n_all, live=n_live, valid=n_valid)
    geom_shape = (tab.l3, tab.d3, tab.d3)

    def timing(key, kernel, plain, nbytes, ops, lib=None):
        ms_k, ms_p = _time_ms(kernel, 20), _time_ms(plain, 3)
        host = _host_ms(kernel, 20)
        bound = _bound(nbytes, 0, ops, False)
        rows[key].update(ms=ms_k, plain_ms=ms_p, bound_ms=bound[0], bound_by=bound[1],
                         library_ms=lib, host_ms=host)
        return (f"kernel {ms_k:.3f} ms (host {host:.3f} ms a call), plain {ms_p:.3f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]})")

    # the yardstick: grid_sample at the same samples, the populated slots'
    # (x, y, z) normalized with align_corners
    size = torch.tensor([tab.d3 - 1, tab.d3 - 1, tab.l3 - 1], device=x.device,
                        dtype=torch.float32)
    g = (zyx.flip(-1) / size * 2 - 1).reshape(1, -1, tab.d2, tab.d2, 3).contiguous()
    src = (x if tab.linear else x * tab.mask.reshape(geom_shape))[:, None]
    mode = "bilinear" if tab.linear else "nearest"
    ms_lib = _time_ms(lambda: F.grid_sample(src, g, mode=mode, padding_mode="zeros",
                                            align_corners=True).sum(-1), 10)
    del g
    t1 = timing(("project", interp), lambda: gk.gather_project(listed, x),
                lambda: gk.gather_project_reference(tab, x), _nbytes(x, p_k) + aux_bytes,
                COORD_OPS * n_listed + VALID_OPS[("project", interp)] * n_valid, ms_lib)
    ms_lib = None
    if not tab.linear:
        # one index_add_ of the valid samples' padded indices (the plain
        # version's), each carrying its ray's value
        idx, val = [], []
        for sl, _, taps, valid in gk._chunks(tab, 0, tab.sampler()):
            valid = valid & (tab.cvf[0, sl] > 0)[:, None, None, None]
            idx.append(taps[0][0][valid])
            val.append(r[0, sl][..., None].expand(valid.shape)[valid])
        idx, val = torch.cat(idx), torch.cat(val)
        acc = tab.sampler().zeros(x.device)
        ms_lib = _time_ms(lambda: acc.index_add_(0, idx, val), 10)
        del idx, val
    t2 = timing(("backproject", interp), lambda: gk.gather_backproject(listed, r),
                lambda: gk.gather_backproject_reference(tab, r), _nbytes(r, pt_k) + aux_bytes,
                COORD_OPS * n_listed + VALID_OPS[("backproject", interp)] * n_valid, ms_lib)
    lib = "" if ms_lib is None else f", index_add_ {ms_lib:.3f} ms"
    live, valid = _sym_items(st)
    t4 = timing(("sym_normal", interp), lambda: gk.sym_normal(st, x),
                lambda: gk.sym_normal_reference(st, x),
                _nbytes(x, sts_k, st.cs, st.sn, st.dz, st.pv) + aux_bytes,
                SYM_COORD_OPS * live + SYM_VALID_OPS[interp] * valid)
    print(f"{label} [{n_all} samples, {n_live} on unpruned rays, {n_valid} valid, "
          f"{listed.n_max} live rays; "
          f"{live} symmetry items, {valid} valid]: K1 {t1}, grid_sample ({mode}) + sum "
          f"{rows[('project', interp)]['library_ms']:.3f} ms; K2 {t2}{lib}; K4 {t4}; {card}",
          flush=True)
    if errs is not None:
        t3 = timing(("jacobian", interp), lambda: gk.pose_jacobian(tab, x, b),
                    lambda: gk.pose_jacobian_reference(tab, x, b), _nbytes(x, b) + aux_bytes,
                    COORD_OPS * n_live + VALID_OPS[("jacobian", interp)] * n_valid)
        print(f"{label}: K3 {t3}; {card}", flush=True)
    return rows


def _one_candidate_tables(device, geom, tw, rp, copies, pairs, pose, interp):
    """The gather and symmetry tables of one candidate (copies (C,), pairs
    (P, 4), (P,)) at pose (tilt, psi, dy), with K3's derivatives when
    linear."""
    import torch

    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    mask = torch.as_tensor(geom.cylindrical_mask().reshape(-1), dtype=torch.float32,
                           device=device)
    cellok = torch.as_tensor(geom.cell_valid_mask().reshape(-1), dtype=torch.float32,
                             device=device)
    tab = gk.gather_tables(geom, [tw], [rp], *(c[None] for c in copies), *pose, interp, mask,
                           cellok, derivatives=interp == "linear")
    st = gk.sym_tables(geom, [tw], [rp], *(c[None] for c in pairs), interp, mask, cellok)
    return tab, st


def phase_gather_kernels(device, tilted, card) -> dict:
    """Phase 10 (a): K1-K4 against their plain versions on the same card
    tensors at phase 9 (b)'s best golden candidate at tilt 3 deg, nn and
    linear (K3 linear only), each timed beside its plain version, its
    bound and its yardstick (_hold_gather)."""
    import torch

    geom, tw, rp, copies, pairs = tilted["golden"]
    rows = {}
    for interp in ("nn", "linear"):
        tab, st = _one_candidate_tables(device, geom, tw, rp, copies, pairs, (3.0, 0.0, 0.0),
                                        interp)
        gen = torch.Generator(device=device).manual_seed(10)
        x = (torch.rand((1,) + geom.volume_shape, device=device, generator=gen)
             * tab.mask.reshape(geom.volume_shape))
        r = torch.rand(tab.shape, device=device, generator=gen)
        b = torch.rand((geom.l2, geom.d2), device=device, generator=gen)
        rows.update(_hold_gather(
            f"phase 10 (a) [{interp}, tilt 3 deg, C={int(copies[2].sum())} populated copies, "
            f"{len(pairs[1])} pair slots]", tab, st, x, r, b, card, timed=True))
    return rows


def phase_sym_share(device, tilted, card) -> dict:
    """Phase 10 (a), last: the share of the symmetry term in one refine
    matvec PT(P(x) * rows) + ST(S(x)) at tilt 3 deg (nn) on the golden
    grid's tables, for one candidate and for the 45 a refine_mode="all"
    launch takes: K4 (ST(S(x)) in one launch) beside the torch S + ST it
    replaced (the taps computed at the build)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import grid
    from helicon_tpu_torch.denovo3d.projector import build_problems

    geom, tw, rp, n_copies, n_pairs, n_ops = tilted["grid"]
    tabs = grid._candidate_tables(geom, tw, rp, n_copies, n_pairs, n_ops)[:5]
    out = {}
    for k in (1, len(tw)):
        ops = build_problems(geom, np.zeros((geom.d2, geom.l2), np.float32), tw[:k], rp[:k],
                             *(t[:k] for t in tabs), 3.0, 0.0, 0.0, "nn",
                             geom.cylindrical_mask(), geom.cell_valid_mask(), device=device)
        x = torch.rand((k,) + geom.volume_shape, device=device) * ops["mask"]
        rows = ops["row_valid"].float()
        ms_k4 = _time_ms(lambda: ops["STS"](x), 10)
        ms_torch = _time_ms(lambda: ops["ST"](ops["S"](x)), 10)
        ms_mv = _time_ms(lambda: ops["PT"](ops["P"](x) * rows) + ops["STS"](x), 10)
        out[k] = dict(sym_ms=ms_k4, torch_sym_ms=ms_torch, matvec_ms=ms_mv,
                      share=ms_k4 / ms_mv)
        print(f"phase 10 (a) [the symmetry term, nn, tilt 3 deg, k={k}, {tabs[3].shape[1]} pair "
              f"slots]: K4 {ms_k4:.3f} ms of a {ms_mv:.3f} ms refine matvec "
              f"({100 * ms_k4 / ms_mv:.1f} %); torch S + ST {ms_torch:.3f} ms; {card}",
              flush=True)
        del ops
    return out


def phase_tilted_again(tilted, card) -> None:
    """Phase 10 (b): phase 9 (b)'s golden grid at tilt 3 deg, now on K1 /
    K2 / K4, beside its wall on the torch gather projector they replaced."""
    t, launches = tilted, tilted["gather_launches"]
    print(f"phase 10 (b) [phase 9 (b) again: 45 golden candidates at tilt 3 deg on the gather "
          f"kernels]: {t['wall']:.3f} s wall incl. best volume ({TORCH_GATHER_TILT3_WALL} s on "
          f"the torch gather projector), {t['rate']:.2f} candidates/s, peak {t['peak']:.2f} GiB, "
          f"launches {launches}; {card}", flush=True)
    if not all(launches[n] > 0 for n in ("gather_project", "gather_backproject", "sym_normal")):
        raise AssertionError("phase 10 (b): the tilted search did not launch K1 / K2 / K4")


def _pose_gate(label, got, want, card, pose_limit=5e-3, score=None) -> tuple:
    """Poses got / want (3,) within pose_limit (deg / px) and, with score =
    (kernels', plain's), scores within 5e-4; prints and fails past them."""
    import numpy as np

    dp = float(np.abs(np.float64(got) - np.float64(want)).max())
    ds = None if score is None else abs(float(score[0]) - float(score[1]))
    tail = "" if ds is None else f", |d score| {ds:.3e} (limit 5e-4)"
    print(f"{label}: kernels {[float(v) for v in got]}, plain {[float(v) for v in want]}, "
          f"max |d pose| {dp:.3e} (limit {pose_limit:g}){tail}; {card}", flush=True)
    if not (dp <= pose_limit and (ds is None or ds <= 5e-4)):
        raise AssertionError(f"{label}: the kernels differ from plain ({dp}, {ds})")
    return dp, ds


def phase_refine_cli(device, phase4_scores, card) -> dict:
    """Phase 10 (c), refinement's main path: the CLI's refinement
    (--refineTiltPsiDy 5 5 2, refineTopK 1, topk) on phase 4's 2,327
    candidates, with K1-K4's counts set to 0 just before and read just
    after: the wall split into search, refine and re-solve, the refined pose
    (inside its bounds, its score finite) and the top-1 with and without
    refinement; fails unless every kernel launched. Then, at the refined
    candidate's own tables (tilt 0, its copies and pairs): K1-K4 against
    plain (nn, the solve's; linear, the Gauss-Newton step's); one
    Gauss-Newton step from the start on the kernels and on plain (new pose
    within 1e-4, r^T r within 1e-4 relative); and its whole refinement on
    the kernels and on plain (poses within 5e-3, the scores at them within
    5e-4)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import gather_kernels as gk
    from helicon_tpu_torch.denovo3d import refine
    from helicon_tpu_torch.denovo3d.refine import _pose_bounds
    from helicon_tpu_torch.denovo3d.solver import solve_candidate

    tw, ri = _real_size_grid()
    calls = []
    real = refine.refine_tilt_psi_dy

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    refine.refine_tilt_psi_dy = spy
    _zero(gk.launches)
    try:
        res, b1, wall, peak = _search(device, tw, ri, return_best_volume=True,
                                      refine_tilt_psi_dy_range=REFINE_RANGE)
    finally:
        refine.refine_tilt_psi_dy = real
    launches = dict(gk.launches)
    e = res.effective
    ((idx, pose),) = res.refined_params.items()
    lo, hi = _pose_bounds(REFINE_RANGE)
    inside = bool(np.all(np.float32(pose) >= lo) and np.all(np.float32(pose) <= hi))
    plain_top = int(np.argmax(phase4_scores))
    print(f"phase 10 (c) [the CLI's refinement, {REFINE_RANGE}, top-1 of {len(tw)} candidates]: "
          f"{wall:.3f} s wall incl. best volume: search {e['search_s']:.3f} s, refine "
          f"{e['refine_s']:.3f} s, re-solve {e['resolve_s']:.3f} s; peak {peak:.2f} GiB; "
          f"launches {launches}, B1 {b1}; refined candidate ({float(tw[idx])}, "
          f"{float(ri[idx])}) pose (tilt, psi, dy px) {tuple(round(v, 5) for v in pose)} "
          f"{'inside' if inside else 'OUTSIDE'} its bounds, score {float(res.scores[idx]):.6f} "
          f"(fixed pose {float(phase4_scores[idx]):.6f}); top-1 with refinement "
          f"({float(tw[res.best_index])}, {float(ri[res.best_index])}), without "
          f"({float(tw[plain_top])}, {float(ri[plain_top])}); {card}", flush=True)
    _check_search(res, b1, "phase 10 (c)")
    if not inside or min(launches.values()) <= 0:
        raise AssertionError(f"phase 10 (c): pose {pose} outside its bounds or a kernel not "
                             f"launched ({launches})")

    # the refined candidate's own call
    ((geom, cfg, region, c_tw, c_rp, copies, pairs, *start, r_range), kw) = calls[0]
    start = np.float32(start)
    label = (f"phase 10 (c) [the refined candidate's tables: tilt 0, C={len(copies[0])} copy "
             f"slots, {len(pairs[1])} pair slots]")
    sol = solve_candidate(geom, cfg, region, c_tw, c_rp, *copies, *pairs, *start, device=device)
    x = sol["rec3d"][None].float().contiguous()
    b = torch.as_tensor(region, dtype=torch.float32, device=device).T.contiguous()
    for interp in ("nn", "linear"):
        tab, st = _one_candidate_tables(device, geom, c_tw, c_rp, copies, pairs, tuple(start),
                                        interp)
        gen = torch.Generator(device=device).manual_seed(11)
        r = torch.rand(tab.shape, device=device, generator=gen)
        _hold_gather(f"{label} {interp}", tab, st, x, r, b, card)
    # one Gauss-Newton step from the start, at the start's solved volume
    step = {}
    for plain in (False, True):
        with _plain_gather() if plain else contextlib.nullcontext():
            step[plain] = refine.gn_step(geom, region, np.float32([c_tw]), np.float32([c_rp]),
                                         tuple(np.asarray(c)[None] for c in copies), x,
                                         start[None])
    moved = float(np.abs(step[False][0][0] - start).max())
    rtr_err = abs(float(step[False][1][0]) - float(step[True][1][0])) / max(
        abs(float(step[True][1][0])), 1e-30)
    _pose_gate(f"{label} one Gauss-Newton step from {start.tolist()} (moves {moved:.4f}; r^T r "
               f"rel err {rtr_err:.3e}, limit 1e-4)", step[False][0][0], step[True][0][0], card,
               pose_limit=1e-4)
    if not (rtr_err <= 1e-4 and moved > 0):
        raise AssertionError(f"phase 10 (c): the Gauss-Newton step's r^T r differs by {rtr_err} "
                             f"or the step did not move ({moved})")
    # the whole refinement, and the scores at its poses
    whole, score = {}, {}
    t = {}
    for plain in (False, True):
        with _plain_gather() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            whole[plain] = np.float32(real(*calls[0][0], **kw))
            t[plain] = time.perf_counter() - t0
            score[plain] = float(solve_candidate(geom, cfg, region, c_tw, c_rp, *copies, *pairs,
                                                 *whole[plain], device=device)["score"])
    if not np.array_equal(whole[False], np.float32(pose)):
        raise AssertionError(f"phase 10 (c): the refinement again gave {whole[False]}, the "
                             f"search {pose}")
    _pose_gate(f"{label} the whole refinement ({t[False]:.3f} s on the kernels, {t[True]:.3f} s "
               f"plain)", whole[False], whole[True], card, score=(score[False], score[True]))
    return dict(wall=wall, launches=launches, pose=pose, search_s=e["search_s"],
                refine_s=e["refine_s"], resolve_s=e["resolve_s"], step_moved=moved,
                kernel_s=t[False], plain_s=t[True])


def phase_refine_all(device, card) -> dict:
    """Phase 10 (d): refine_mode="all" on the 45-candidate golden grid at
    max_iter 5 (wall, candidates/s, K1-K4 launches), run twice: the scores
    and poses must repeat bit for bit. Then whole refinements once on the
    kernels and once on their plain versions on the same card, held to
    poses within 5e-3 (deg / px) and scores within 5e-4, the reference's
    engine-vs-JAX bounds: the winner's, and that of the candidate whose
    pose moved furthest (on the kernels twice: bit for bit)."""
    import numpy as np

    from helicon_tpu_torch.denovo3d import gather_kernels as gk
    from helicon_tpu_torch.denovo3d import refine

    rr = dict(REFINE_RANGE, max_iter=5)
    tw, ri = _golden_grid()
    calls = []
    real = refine.refine_all_candidates

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    runs = []
    for _ in range(2):
        refine.refine_all_candidates = spy
        _zero(gk.launches)
        try:
            res, _, wall, peak = _golden_search(device, tw, ri, refine_tilt_psi_dy_range=rr,
                                                refine_mode="all", return_best_volume=True)
        finally:
            refine.refine_all_candidates = real
        runs.append((res, wall, peak, dict(gk.launches)))
    res, wall, peak, launches = runs[0]
    e = res.effective
    params = [np.float32([r.refined_params[j] for j in range(len(tw))]) for r, *_ in runs]
    same = bool(np.array_equal(runs[0][0].scores, runs[1][0].scores)
                and np.array_equal(params[0], params[1]))
    print(f"phase 10 (d) [refine_mode all, {rr}, {len(tw)} golden candidates]: {wall:.3f} s "
          f"wall incl. best volume ({runs[1][1]:.3f} s again), {len(tw) / wall:.2f} "
          f"candidates/s, refine {e['refine_s']:.3f} s, peak {peak:.2f} GiB, launches "
          f"{launches}; top-3 {res.top(3).tolist()}, again {runs[1][0].top(3).tolist()}: scores "
          f"and poses {'repeat bit for bit' if same else 'DIFFER'}; best pose "
          f"{res.refined_params[res.best_index]}; {card}", flush=True)
    if min(launches.values()) <= 0 or not np.all(np.isfinite(res.scores)) or not same:
        raise AssertionError("phase 10 (d): a kernel not launched, non-finite scores, or a "
                             "second run that differs")
    (geom, cfg, region, twists, rises, tables, *pose0, r_range), kw = calls[0]

    def run(i, plain=False):
        one = (geom, cfg, region, twists[i : i + 1], rises[i : i + 1],
               tuple(t[i : i + 1] for t in tables), *pose0, r_range)
        t0 = time.perf_counter()
        with _plain_gather() if plain else contextlib.nullcontext():
            s, p = real(*one, batch_size=1, device=device)
        return s[0], p[0], time.perf_counter() - t0

    moved = np.abs(params[0] - np.float32(pose0)).max(axis=1)
    mover = int(np.argmax(moved))
    out = dict(wall=wall, rate=len(tw) / wall, launches=launches, repeat=same)
    for name, i in (("the winner", res.best_index), ("the furthest mover", mover)):
        s_k, p_k, t_k = run(i)
        s_p, p_p, t_p = run(i, plain=True)
        dp, ds = _pose_gate(f"phase 10 (d) [{name}'s whole refinement: candidate {i}, moved "
                            f"{float(moved[i]):.4f}; {t_k:.3f} s on the kernels, {t_p:.3f} s "
                            f"plain]", p_k, p_p, card, score=(s_k, s_p))
        s_a, p_a, _ = run(i)
        if not (np.array_equal(p_a, p_k) and s_a == s_k):
            raise AssertionError(f"phase 10 (d): {name}'s refinement does not repeat on the "
                                 f"kernels ({p_k}, {p_a})")
        out[name] = dict(pose_err=dp, score_err=ds, kernel_s=t_k, plain_s=t_p,
                         moved=float(moved[i]))
    return out


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

    t_start = time.perf_counter()
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
    res, b1_launches = phase_real_size(device)
    k = cmp[("bfloat16", 179)]
    # kernel launches of one B1 solve call (phase 4 makes one per launch)
    solve_launches = b1_launches // -(-res.effective["n_groups"]
                                       // res.effective["groups_per_launch"])
    groups = tuple(res.effective[f] for f in ("n_groups", "R", "C_u", "n_ops"))
    if k["groups"] != groups:
        raise AssertionError(f"phase 2 solved groups {k['groups']}, phase 4 {groups} "
                             "(n_groups, R, C_u, n_ops)")
    single = phase_single_candidate(device, res)
    nn_scores = res.scores
    del res
    lin, _ = phase_real_size(device, interpolation="linear")
    phase_golden(device, interpolation="linear", top1=LINEAR_GOLDEN_TOP1)
    env_kernel = phase_envelope_kernel(device)
    env = phase_envelope_search(device)
    c10 = phase_c10(device, {
        "nn": (nn_scores, {}), "linear": (lin.scores, dict(interpolation="linear")),
        "elasticnet": (env["elasticnet"]["res"].scores, dict(ENVELOPE)["elasticnet"]),
        "ssim": (env["ssim"]["res"].scores, dict(ENVELOPE)["ssim"]),
    })
    t7 = env_kernel["timing"]
    bucketed = phase_bucketed(device)
    phase_bucketed(device, "phase 8 (a) [the CLI's prep]", transpose=-1, horizontalize=1)
    r1 = phase_r1(device, bucketed)
    phase_incremental(device, nn_scores)
    phase_checkpointed(device, bucketed)
    phase_prep(device)
    phase_fsc1(device, solve_launches)
    second = phase_second_pass(device, bucketed)
    tilted = phase_tilted(device)
    ard = phase_ard(device, single)
    fsc_reg = phase_fsc_regularized(device, single)
    gather = phase_gather_kernels(device, tilted, card)
    sym_share = phase_sym_share(device, tilted, card)
    phase_tilted_again(tilted, card)
    cli = phase_refine_cli(device, nn_scores, card)
    refine_all = phase_refine_all(device, card)

    def entry(name, src, replaces, launches, r, **extra):
        return dict(name=name, route="cuda", source=CSRC + src, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"), **extra)

    def other(n, interp):
        """A gather kernel's launches on phase 9 (b)'s and 10 (d)'s paths,
        and its linear row of phase 10 (a)."""
        extra = dict(launches_tilt3=tilted["gather_launches"][n],
                     launches_refine_all=refine_all["launches"][n])
        if interp:
            extra["linear"] = interp
        return extra

    rows = single["rows"]
    b2, b3 = rows[("solve_candidate", "nn", "float32")], rows[("score_candidate", "nn", "float32")]
    f32 = cmp[("float32", 1)]
    print(json.dumps({"kernels": [
        entry("group_solve", "group_solve.cu", "helicon_tpu/denovo3d/pallas_solver.py:754",
              b1_launches, k, bound_two_pass_ms=k["bound_two_pass_ms"],
              products=k["products"],
              float32_one_group=dict(ms=f32["ms"], plain_ms=f32["plain_ms"],
                                     bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
                                     products=f32["products"]),
              # phase 7: elasticnet's l1 + l2 call at G = 179 (launches on
              # its full-width search, retry rounds included), an fsc
              # half-set call, and the options' errors against plain
              regularized=dict(config="elasticnet", ms=t7["ms"], plain_ms=t7["plain_ms"],
                               bound_ms=t7["bound_ms"], bound_by=t7["bound_by"],
                               l2_only_ms=t7["l2_ms"], lsq_ms=t7["lsq_ms"],
                               launches=env["elasticnet"]["launches"],
                               retry_rounds=env["elasticnet"]["res"].effective["retry_rounds"],
                               x_rel_err=env_kernel[("l1_l2_no_score", "float32")]["x_rel_err"]),
              fsc=dict(half_ms=t7["fsc_half_ms"], bound_ms=t7["fsc_half_bound_ms"],
                       bound_by=t7["fsc_half_bound_by"], launches=env["fsc2"]["launches"],
                       score_abs_err=env_kernel[("fsc_half", "float32")]["score_abs_err"]),
              c10={k: {f: v[f] for f in ("overlap", "spearman", "max_delta", "met")}
                   for k, v in c10.items()},
              # phase 8: launches on the bucketed path by pass (the second
              # pass goes per candidate: B2)
              # phase 8 (b): the forced route of groups of one
              # (HELICON_GRID_GROUPED=1), B1 at R = 1 against plain
              forced_r1={f: r1[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "groups")},
              bucketed=dict(launches_first=bucketed["sums"]["first"]["launches"],
                            launches_second=bucketed["sums"]["second"]["launches"],
                            launches_winner=bucketed["sums"]["winner"]["launches"])),
        entry("solve_candidate", "candidate_solve.cu", "helicon_tpu/denovo3d/pallas_solver.py:100",
              single["launches"]["solve_candidate"], b2,
              bound_two_pass_ms=b2["bound_two_pass_ms"], products=b2["products"],
              breakdown_ms=b2["breakdown_ms"],
              # phase 8 (a) and 9: the per-candidate path's B2 launches
              # (solves and matvecs), one second-pass launch against plain,
              # the matvec entry (ard) and the j-dependent z-Gram (fsc halves)
              percand=dict(
                  launches_second_pass=bucketed["sums"]["second"]["b2_launches"],
                  launches_winner=bucketed["sums"]["winner"]["b2_launches"],
                  launches_ard=ard["launches"], launches_fsc_elasticnet=fsc_reg["launches"],
                  launches_tilt=tilted["b2_launches"],
                  second_pass={f: second[f] for f in ("max_abs_err", "float32_err", "ms",
                                                       "plain_ms", "bound_ms", "bound_by")},
                  # ard's and elasticnet + fsc 2's golden searches, B2
                  # against plain (score errors), one of each search's
                  # launches timed, and phase 5's float32 k = 8 checks
                  matvec=dict(score_abs_err=ard["max_abs_err"],
                              float32_score_abs_err=ard["float32_err"],
                              search=ard["search_matvec"], k8=ard["k8"]),
                  gz_j=dict(score_abs_err=fsc_reg["max_abs_err"],
                            float32_score_abs_err=fsc_reg["float32_err"],
                            search=fsc_reg["search_half"], k8=fsc_reg["k8"]),
                  gather_projector=dict(P_ms=tilted["P_ms"], PT_ms=tilted["PT_ms"]))),
        entry("score_candidate", "candidate_solve.cu",
              "helicon_tpu/denovo3d/pallas_solver.py:335",
              single["launches"]["score_candidate"], b3,
              bound_two_pass_ms=b3["bound_two_pass_ms"]),
        # the gather projector, the pose Jacobian and the symmetry term (no
        # Pallas kernel: they replace XLA gathers and jax.jacfwd); nn rows,
        # launches on phase 10 (c), the CLI's refinement
        entry("gather_project", "gather_projector.cu", "helicon_tpu/denovo3d/projector.py:153",
              cli["launches"]["gather_project"], gather[("project", "nn")],
              **other("gather_project", gather[("project", "linear")])),
        entry("gather_backproject", "gather_projector.cu",
              "helicon_tpu/denovo3d/projector.py:153", cli["launches"]["gather_backproject"],
              gather[("backproject", "nn")],
              **other("gather_backproject", gather[("backproject", "linear")])),
        entry("pose_jacobian", "gather_projector.cu", "helicon_tpu/denovo3d/refine.py:50",
              cli["launches"]["pose_jacobian"], gather[("jacobian", "linear")],
              **other("pose_jacobian", None)),
        entry("sym_normal", "gather_projector.cu", "helicon_tpu/denovo3d/projector.py:230",
              cli["launches"]["sym_normal"], gather[("sym_normal", "nn")],
              **other("sym_normal", gather[("sym_normal", "linear")]),
              # phase 10 (a): K4 and the torch S + ST it replaced in a
              # refine matvec, by k
              share={str(k): v for k, v in sym_share.items()}),
    ]}))
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
