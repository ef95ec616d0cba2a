#!/usr/bin/env python3
"""Drive the PyTorch port's grid search and kernels once on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. It builds the port's kernels from the sources in the
checkout, then runs sixteen phases and fails (non-zero exit) if any fails:

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
   timed beside its bound, its products beside cuBLAS's bmm; (c) phase
   4's search as the web app calls it, with progress_callback and
   should_abort and no batch_size (launches of the reference's automatic
   batch), then aborted after its first launch;
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
   its bound and its products beside cuBLAS's bmm; (b) the golden grid
   at tilt 3 deg on the gather projector
   (wall, candidates/s, peak memory, finite scores), the gather P and PT
   per application, and four golden candidates at tilt 0 on the gather
   projector against the separable path (float32 scores within 1e-4);
   (c) ard on the golden grid (B2's matvec entry under the EM loop) with
   the entry and with its plain version on the same card tensors
   (bfloat16 scores within 1e-3, float32 within 1e-4), one of the
   search's matvecs timed with both beside its bound (its products beside
   cuBLAS's bmm), and the entry
   against plain on phase 5's float32 inputs (relative 1e-5); (d)
   elasticnet with fsc_test=2 on the golden grid with B2 and with its
   plain version (the halves on j-dependent z-Grams; the same gates),
   one of the search's half solves timed beside its bound, and B2 on an
   fsc half's j-dependent z-Gram against plain on phase 5's float32
   inputs (x within 1e-3 relative);
10. pose refinement on the gather kernels (K1 gather_project, K2
   gather_backproject, gather_normal (the solves' data term PT(rows *
   P(x)) in one call), sample_table (each listed ray's samples, once a
   pose), K3 pose_jacobian (on the list of live rays), sym_items (K4's
   item list, once a pose), K4 sym_normal): (a) each against its plain
   version at phase 9 (b)'s best golden candidate at tilt 3 deg, nn and
   linear (P within 1e-5 of its max, P, PT, gather_normal, nn's table,
   K4's item list and ST(S(x)) bit for bit, nn's K1 / K2 / gather_normal
   with the table and without, J^T J and J^T r 1e-4 relative), timed
   beside its plain version, its bound and a yardstick (grid_sample + the
   ray sum for P, index_add_ of the precomputed taps for PT, nn and
   linear), gather_normal beside K1 + multiply + K2, then each step of
   K1's, K2's, gather_normal's and K4's C entries and K3's kernel alone
   (device ms, queued behind a sleeping kernel; nn with the table and
   without) beside the floor of a launch (an empty kernel), and K4's share
   of a refine matvec beside the torch S + ST it replaced, K4 held bit for
   bit at k = 1 and k = 45; (b) phase 9 (b)'s wall on the kernels beside the torch gather
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
   power limit;
11. the batch CLI as a user runs it, a subprocess on a two-image .mrcs
   stack of the amyloid written with the port's write_mrc, with the CLI's
   own defaults: (a) phase 4's grid, its .csv against reconstruct_grid
   called in this process with exactly the CLI's keyword arguments (the
   same order, scores within 1e-5), with the subprocess's wall, the
   search's wall inside it, the first-call costs, candidates/s, top-1 and
   the kernels' launches from its verbose effective line; (b) the same
   with --refineTiltPsiDy 5 5 2, its refined pose equal to the call in
   process, and at that refined candidate's tables K1-K4, one
   Gauss-Newton step and the whole refinement against plain (phase 10
   (c)'s gates); (c) --imageIndex 0: .batch.json with two equal rows; (d)
   phase 8 (a)'s wide-rise grid at its iterations in two processes on the
   one card, with the environment torchrun sets, against one process: in
   float32 (the same top-10, scores within 1e-4) and in the CLI's default
   bfloat16 (the same top-10, scores within 1e-3), each rank's wall,
   candidates, launches, peak memory and exchange time; and the one
   process's float32 search in this process with its first B1 launch
   and first B2 launch held against plain (scores within 1e-4, x within
   1e-3 relative);
12. the denovo3D web app's compute path: (a) process_one_task at the
   golden's top-1 (2.0 deg, 4.75 A) on the amyloid at 2 A/px in float32,
   at tilt 0 (lsq_reconstruct on B2) and with the app's refinement
   (refine_tilt 5: K1-K4): at the bench's iterations (set as SolveConfig's
   defaults) held against the same task with device="cpu" (tilt 0) or on
   plain K1-K4 and B2 on the card (the refinement): score 1e-4, rec3d and
   the three display images 1e-3 relative; then at the app's own budget
   (120 / 120 / 8), timed only and checked finite; each run with its wall
   and parts (lsq_reconstruct's tables, refine, pair tables and solve with
   its build / solve / score, the re-symmetrization, transform_map, and the
   rest: prep and display; timed by wrapping those functions), then
   apply_helical_symmetry's shape, copies and time and transform_map's
   (CUDA events); (b) the workflow's run_grid_incremental on phase 4's grid:
   every snapshot best-first, the scores within 1e-6 of phase 8 (c)'s same
   call, then an abort after the first launch ranking only scored rows;
   (c) the simulation mode, symmetrize_projection of (a)'s volume at the
   app's defaults, a finite (1, 128, 256) stack; (d) fsc 2 with lreg and
   with ssim on B1's grouped path (halves scored in torch) on 260
   candidates of phase 4, against the plain B1 (float32 1e-4, bf16 1e-3);
13. the 3D-map commands on a seeded 320^3 fibril map at 1 A/px (Gaussian
   blobs on a 4.75 A-rise, -1.2 deg-twist helix at 30-50 A radius) and its
   two half maps (the map plus independent low-passed noise): (a) trueFSC
   at its defaults as a subprocess on the card (wall start to exit), then
   in this process with its parts timed (the FSCs, the phase
   randomizations and their random draws, the lowpass, the threshold, the
   seeds, the growth and its dilations, each distance transform and each
   evaluation of the soft-edge search), its peak device memory and the
   true FSC's 0.143 resolution, and the card's random draw against the
   numpy threefry (bit for bit); (b) trueFSC on the pair's central 128^3
   with --device cuda and cpu under one numpy seed (curves within 1e-4, the
   masks' differing voxels counted, a phase-randomized map within 1e-5
   relative); (c) proc3d's chain (fft_resample to 256^3, helical_sym,
   flip_hand z, clip to 200^3, z_moving_average 4.75 A) as a subprocess on
   the card (wall start to exit) and in this process with each option
   timed, and at 96^3 with --device cuda against cpu (1e-5 relative);
   (a) also prints the largest bin of Otsu's histogram against 2^24
   (ROADMAP C13). This phase launches no hand-written kernel;
14. curvelet denoising on phase 13's fibril map with seeded Gaussian
   noise: (a) proc3d --denoiseCurvelet sigma=3 as a subprocess on the card
   (wall start to exit; a finite map of the input's shape that differs
   from it); (b) the same command in this process with the window build,
   the forward pass (ifftn of F U_k), the medians, the thresholds and the
   inverse pass timed, the card synchronised around each, its peak device
   memory (under 16 GiB: the (37, n^3) complex stacks are never held
   whole) and its 37 bands; (c) the tight frame at 320^3: sum_k U_k^2 = 1
   within 1e-6, and the transform and inverse with nothing thresholded
   give back the map within 1e-5; (d) the map's 96^3 centre through
   proc3d with --device cuda against cpu, nDirs 6 and 0: every keep
   decision that differs lies within 1e-5 relative of its band's
   threshold (their count printed), the maps within 1e-4 of the CPU
   map's peak once the differing coefficients' own synthesis is taken
   out (a coefficient that close to its threshold moves a map by up to
   ~9 % of its peak); (e) denoise_curvelet_2d (udct, mct) and
   curvelet_denoise_batch_mct on 64 images of 256^2 (slices of the noisy
   map), card against CPU the same way. No hand-written kernel either;
15. helical indexing, cross-correlation, the CTF and ptychography, each
   step timed with the card synchronised around it, with its peak device
   memory: (a) 200 class averages of 384^2 at 0.6 A/px (an amyloid, a
   TMV-like rod and a C3 tube from the port's simulator, plus seeded
   noise) through compute_power_spectra_batch and
   detect_layer_lines_batch, then estimate_helical_parameters on one image
   of each geometry; the spectra within 1e-5 of the CPU's, the lines
   equal (a line on one side only within 1e-4 relative of
   min_prominence, counted) and the candidate tables equal where the lines
   are; (b) batched_cross_correlation of 100 classes against 20,000
   segments of 128^2 (the first 500 shifted copies of classes plus
   noise), spectra, products with their inverse FFTs and peaks timed
   apart, 10 x 500 pairs against the CPU (peaks 1e-5 relative; a shift
   that differs only between two peaks within 1e-5), the planted shifts
   recovered; (c) ctf_2d of 1,000 defoci at 512^2, 16 against the CPU
   within 3 float32 ulps of the largest phase; (d) ptychography after
   the loader (parallax and ePIE, 5 epochs of batch 256) on a synthetic
   128 x 128 scan with a 128^2 detector (tests/test_aux_modules.py's
   fixture rule), the phase finite, the defocus estimate beside the
   truth; a 24 x 24 scan with a 64^2 detector on the card and the CPU
   (within 1e-4 rad on a vacuum probe with a 1 % floor; the hard
   aperture's difference printed), each run twice on the card bit for
   bit; (e) map_coordinates order 0 in every mode (bit for bit),
   apply_rotation and the two gathers (1e-6) on the card against the CPU.
   No hand-written kernel: none of these reaches a TPU kernel.
16. images2star (commands/images2star.py and ops/images2star/), its files
   under build/phase16/, each part timed with the card synchronised around
   it, with its peak device memory: (a) bench.py's ETL chain on its
   100,000-row frame (select 10 of 50 classes, addParm, multParm, sortby,
   breakFilaments maxSegments=20, removeDuplicates, write, read back) as
   ``helicon-torch images2star`` in a subprocess, start to exit, and twice
   in process with the read, the plugins and the write timed apart
   (rows/s); the three runs must write equal files; (b) --createStack
   out.mrcs:rescale2size=128 on 4,000 particles of 256^2 in 8 stacks of 500
   (a simulated amyloid projection plus seeded noise): images/s and peak
   memory; 16 of them with float16=0 on the card against the CPU within
   1e-5 of each image's peak, the float16 stack within that plus one
   float16 ulp of those; (c) --maskGold on 4 micrographs of 4,096^2 at 1
   A/px with 40 planted gold discs each, gradient_sigma automatic (100 A):
   seconds per micrograph; micrograph 0's mask on the card against the
   CPU's (a pixel may differ only within 1e-5 relative of a threshold), at
   least half the discs' pixels masked, and the option's output the card's
   decision; (d) --denoiseCurvelet transform=mct on 500 particles of 256^2
   and, at the defaults, on one micrograph and on 8 (links to (c)'s):
   seconds and peak memory, the peak of 8 within two micrographs' bytes of
   the peak of one and the first micrograph equal in both runs; 4 particles
   on the card against the CPU at phase 14's gate (the kept-mask rule, 1e-4
   with the differing decisions' synthesis taken out);
   (e) --extractHelices width=300 on 25 segments on each of (c)'s
   micrographs: seconds; 4 strips of micrograph 0 against the CPU's within
   1e-5 of the strip's peak; (f) --calibratePixelSize gold on 100 images of
   512^2 with a ring at 2.355 A planted on an integer radius and the pixel
   size set 2 % off: apix_new equal to the CPU's and within 0.1 % of the
   truth.
   No hand-written kernel: none of these reaches a TPU kernel.

A line before phase 1 lists which optional host packages the machine
has. The last two lines of standard output are the card's name and power
limit, and {"ok": true, "device": {...}}; the line before them lists each
kernel with its launches on its own path (phase 4 for B1, phase 5 for B2
and B3, phase 10 (c) for the gather kernels; B1's and B2's on the
bucketed path of
phase 8, B2's on phase 9's per-candidate searches too, with its matvec
entry and its j-dependent z-Gram; K1-K4's on phases 9 (b) and 10 (d)),
and on phase 11's CLI runs (launches_cli; B1's and B2's first float32
launches of (d) against plain, cli_wide_float32) and phase 12's
(launches_webapp), its error against the
plain version, its time, the plain version's time and the least time the card could take for the same work
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


def _device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call between CUDA events around reps
    calls enqueued behind a sleeping kernel, after one warm-up: the calls
    run back to back on the card whatever the host's pace, so small
    launches read their own time, not the host's."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of the card: the queue fills meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    products = _time_products(inp.a_top, R * l3, f"phase 8 (b) [R={R}, G={G}]",
                              gs.padded_pitch(inp.a_top.shape[1]))
    return dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
                groups=(G, R, C_u, O), products=products)


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
    return dict(launches=n_launch, wall=wall, wall_one=wall_one, scores=res.scores)


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
    label = (f"phase 9 (a) [one B2 launch: k={k} C={C} O={O} l3={l3} d3^2={d3sq}, "
             f"{inp.a_top.dtype}]")
    print(f"{label}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by})", flush=True)
    products = _time_products(inp.a_top, l3, label, inp.a_top.shape[1])
    return dict(max_abs_err=out["bfloat16"], float32_err=out["float32"], ms=ms_k,
                plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by, shape=(k, C, O, l3, d3sq),
                products=products)


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

    def timed(inp, v, label, products=False):
        got, want = cs.candidate_matvec(inp, v), cs.candidate_matvec_reference(inp, v)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        ms_k = _time_ms(lambda: cs.candidate_matvec(inp, v), 20)
        ms_p = _time_ms(lambda: cs.candidate_matvec_reference(inp, v), 20)
        bound_ms, bound_by = _bound(*_single_work(inp, nm=1),
                                    bf16=inp.a_top.dtype == torch.bfloat16)
        k, C, O, l3, d3sq = inp.shape
        head = (f"phase 9 (c) [{label}: the matvec entry, {inp.a_top.dtype}, k={k} C={C} O={O} "
                f"l3={l3} d3^2={d3sq}]")
        print(f"{head}: rel err {rel:.3e}, kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({bound_by})", flush=True)
        row = dict(max_abs_err=float((got - want).abs().max()), rel_err=rel, ms=ms_k,
                   plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by)
        if products:
            row["products"] = _time_products(inp.a_top, l3, head, inp.a_top.shape[1])
        return row

    out["search_matvec"] = timed(*record[0], "one of the search's matvecs", products=True)
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
# K4's item list, once a pose: each live item's coordinates and tests as
# above; linear's valid items besides their two cells' fractions,
# complements and eight weights (2 x 22)
SYM_ITEM_OPS = {"nn": 0, "linear": 44}
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

    names = GATHER_KERNELS
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
    rays the projector builds, with its sample table (equal to the plain
    table) and without; gather_normal likewise; J^T J and J^T r within
    1e-4 relative. timed: each kernel (K1, K2, gather_normal on the list
    and its table, the table's build) and its plain version timed by CUDA
    events beside its bound, and the yardsticks: for P
    torch.nn.functional.grid_sample (5-D, nearest / bilinear, zero padding)
    on the same samples plus the sum along the ray; for PT one index_add_
    of the same valid samples' taps. Returns the rows by (kernel,
    interpolation)."""
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
    torch.cuda.synchronize()
    list_ms = (time.perf_counter() - t0) * 1e3
    # nn: the list's sample table against the plain table, and the list
    # with it and without (linear lists compute their samples)
    if (listed.sidx is None) != tab.linear:
        raise AssertionError(f"{label}: the list's sample table is "
                             f"{'missing' if listed.sidx is None else 'there'}")
    on_lists = (listed,)
    if listed.sidx is not None:
        table_same = bool(torch.equal(listed.sidx, gk.sample_table_reference(listed)))
        rows[("table", interp)] = dict(max_abs_err=0.0 if table_same else float("inf"),
                                       equal=table_same, table_mb=_nbytes(listed.sidx) / 1e6)
        if not table_same:
            raise AssertionError(f"{label}: the sample table differs from the plain table")
        on_lists += (dataclasses.replace(listed, sidx=None),)
    p_l = [gk.gather_project(on, x) for on in on_lists]
    torch.cuda.synchronize()
    err_p, rv_same = _rel(p_k, p_p), bool((rv_k == rv_p).all())
    p_same = all(torch.equal(p, p_p) for p in (p_k, *p_l))
    row = dict(max_abs_err=float(max((p - p_p).abs().max() for p in (p_k, *p_l))),
               rel_err=err_p, equal=p_same, live_rays=listed.n_max, list_build_ms=list_ms)
    if not (err_p <= 1e-5 and rv_same and p_same):
        raise AssertionError(f"{label}: K1 differs from plain ({err_p}, {rv_same}, {p_same})")
    # K2
    pt_k, pt_p = gk.gather_backproject(tab, r), gk.gather_backproject_reference(tab, r)
    pt_l = [gk.gather_backproject(on, r) for on in on_lists]
    torch.cuda.synchronize()
    pt_same = all(torch.equal(p, pt_p) for p in (pt_k, *pt_l))
    rows[("backproject", interp)] = dict(max_abs_err=float((pt_k - pt_p).abs().max()),
                                         equal=pt_same)
    if not pt_same:
        raise AssertionError(f"{label}: K2 differs from plain by "
                             f"{float((pt_k - pt_p).abs().max())}")
    # gather_normal at the solver's rows, full and with an fsc-like weighting
    w = (torch.arange(tab.l2 * tab.d2, device=x.device) % 3 != 0).float().reshape(tab.l2, tab.d2)
    rows_n = rv_k.float()
    nm_same, nm_err = True, 0.0
    for rw in (rows_n, rows_n * w):
        nm_p = gk.gather_normal_reference(tab, x, rw)
        for on in on_lists:
            nm_k = gk.gather_normal(on, x, rw)
            torch.cuda.synchronize()
            nm_same = nm_same and bool(torch.equal(nm_k, nm_p))
            nm_err = max(nm_err, float((nm_k - nm_p).abs().max()))
    rows[("normal", interp)] = dict(max_abs_err=nm_err, equal=nm_same)
    if not nm_same:
        raise AssertionError(f"{label}: gather_normal differs from plain by {nm_err}")
    # K4, and its item list (made at its first call) against the plain list
    sts_k, sts_p = gk.sym_normal(st, x), gk.sym_normal_reference(st, x)
    torch.cuda.synchronize()
    sts_same = bool(torch.equal(sts_k, sts_p))
    rows[("sym_normal", interp)] = dict(max_abs_err=float((sts_k - sts_p).abs().max()),
                                        equal=sts_same)
    lst = gk.sym_list(st)
    items_same = all((a is None and c is None) or torch.equal(a, c) for a, c in zip(
        (lst.iptr, lst.itap, lst.iw), gk.sym_items_reference(st)))
    rows[("sym_items", interp)] = dict(max_abs_err=0.0 if items_same else float("inf"),
                                       equal=items_same, items=int(lst.iptr[-1]),
                                       incidences=lst.cinc.numel())
    if not (sts_same and items_same):
        raise AssertionError(f"{label}: K4 differs from plain by "
                             f"{float((sts_k - sts_p).abs().max())}, or its item list from the "
                             f"plain list ({items_same})")
    # K3, on the list of live rays (the rows it counts: K1's row validity)
    errs = None
    if tab.linear and tab.dR is not None:
        jk, jp = gk.pose_jacobian(listed, x, b), gk.pose_jacobian_reference(tab, x, b)
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
          f"{'equal' if rv_same else 'DIFFERS'}; "
          + ("" if listed.sidx is None else
             f"the list's sample table ({rows[('table', interp)]['table_mb']:.1f} MB) equal to "
             "plain; ")
          + f"K1, K2 (every ray tested, and on the list of {listed.n_max} live rays, built in "
          f"{list_ms:.3f} ms{'' if listed.sidx is None else ', with and without its table'}), "
          f"gather_normal (rows: the valid rows, and with an fsc-like weighting) and K4 (on its "
          f"list of {rows[('sym_items', interp)]['items']} items, equal to the plain list) equal "
          f"to plain bit for bit{k3}; {card}", flush=True)
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
        host, dev = _host_ms(kernel, 20), _device_ms(kernel, 20)
        bound = _bound(nbytes, 0, ops, False)
        rows[key].update(ms=ms_k, plain_ms=ms_p, bound_ms=bound[0], bound_by=bound[1],
                         library_ms=lib, host_ms=host, device_ms=dev)
        return (f"kernel {ms_k:.4f} ms (device alone {dev:.4f} ms, host {host:.4f} ms a call), "
                f"plain {ms_p:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")

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
    # one index_add_ of the valid samples' taps (the plain version's
    # indices: nn one into the padded volume, linear the cell's eight),
    # each carrying its ray's value times the tap's weight, precomputed
    idx, val = [], []
    for sl, _, taps, valid in gk._chunks(tab, 0, tab.sampler()):
        valid = valid & (tab.cvf[0, sl] > 0)[:, None, None, None]
        rv = r[0, sl][..., None].expand(valid.shape)
        for i, wt in taps:
            idx.append(i.expand(valid.shape)[valid])
            val.append((rv if wt is None else wt * rv)[valid])
    idx, val = torch.cat(idx), torch.cat(val)
    acc = tab.sampler().zeros(x.device)
    ms_lib = _time_ms(lambda: acc.index_add_(0, idx, val), 10)
    del idx, val
    t2 = timing(("backproject", interp), lambda: gk.gather_backproject(listed, r),
                lambda: gk.gather_backproject_reference(tab, r), _nbytes(r, pt_k) + aux_bytes,
                COORD_OPS * n_listed + VALID_OPS[("backproject", interp)] * n_valid, ms_lib)
    lib = f", index_add_ {ms_lib:.4f} ms"
    # gather_normal at the valid rows, beside the composition it replaced
    # (K1 on the list, the multiply, K2 on the list)
    t5 = timing(("normal", interp), lambda: gk.gather_normal(listed, x, rows_n),
                lambda: gk.gather_normal_reference(tab, x, rows_n),
                _nbytes(x, nm_k, listed.ridx) + aux_bytes + 4 * listed.n_max,
                2 * COORD_OPS * n_listed + (VALID_OPS[("project", interp)]
                                            + VALID_OPS[("backproject", interp)]) * n_valid)

    def composed():
        return gk.gather_backproject(listed, gk.gather_project(listed, x) * rows_n)

    comp = dict(ms=_time_ms(composed, 20), device_ms=_device_ms(composed, 20),
                host_ms=_host_ms(composed, 20))
    rows[("normal", interp)]["composition"] = comp
    # the nn sample table's build, once a pose: it computes what K1 computes
    t6 = "" if listed.sidx is None else "; the sample table " + timing(
        ("table", interp), lambda: gk.sample_table(listed),
        lambda: gk.sample_table_reference(listed),
        _nbytes(listed.ridx, listed.sidx) + aux_bytes, COORD_OPS * n_listed)
    live, valid = _sym_items(st)
    t4 = timing(("sym_normal", interp), lambda: gk.sym_normal(st, x),
                lambda: gk.sym_normal_reference(st, x),
                _nbytes(x, sts_k, st.cs, st.sn, st.dz, st.pv) + aux_bytes,
                SYM_COORD_OPS * live + SYM_VALID_OPS[interp] * valid)
    # K4's item list, once a pose: its two build kernels, and the whole
    # list (with the incidences' sort) on fresh tables, host clock
    t7 = timing(("sym_items", interp), lambda: gk.sym_items(st),
                lambda: gk.sym_items_reference(st),
                _nbytes(st.cs, st.sn, st.dz, st.pv, st.inmask, lst.iptr, lst.itap,
                        *(() if lst.iw is None else (lst.iw,))) + aux_bytes,
                SYM_COORD_OPS * live + SYM_ITEM_OPS[interp] * valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        gk.sym_list(dataclasses.replace(st))
    torch.cuda.synchronize()
    rows[("sym_items", interp)]["list_build_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    print(f"{label} [{n_all} samples, {n_live} on unpruned rays, {n_valid} valid, "
          f"{listed.n_max} live rays; "
          f"{live} symmetry items, {valid} valid]: K1 {t1}, grid_sample ({mode}) + sum "
          f"{rows[('project', interp)]['library_ms']:.3f} ms; K2 {t2}{lib}; gather_normal {t5}, "
          f"against K1 + multiply + K2 {comp['ms']:.4f} ms (device alone {comp['device_ms']:.4f} "
          f"ms, host {comp['host_ms']:.4f} ms a call); K4 {t4}; its item list's build "
          f"kernels {t7}, the whole list with its incidences' sort "
          f"{rows[('sym_items', interp)]['list_build_ms']:.3f} ms a pose "
          f"({rows[('sym_items', interp)]['incidences']} incidences){t6}; {card}", flush=True)
    parts = _gather_breakdown(listed, x, r, rows_n, st, b if errs is not None else None)
    rows[("backproject", interp)]["breakdown_ms"] = parts
    print(f"{label}: device ms a step, queued behind a sleep: "
          + ", ".join(f"{n} {v:.4f}" if isinstance(v, float) else f"{n} {v}"
                      for n, v in parts.items()) + f"; {card}", flush=True)
    if errs is not None:
        t3 = timing(("jacobian", interp), lambda: gk.pose_jacobian(listed, x, b),
                    lambda: gk.pose_jacobian_reference(tab, x, b),
                    _nbytes(x, b, listed.ridx) + aux_bytes,
                    COORD_OPS * n_listed + VALID_OPS[("jacobian", interp)] * n_valid)
        print(f"{label}: K3 {t3}; {card}", flush=True)
    return rows


def _gather_breakdown(listed, x, r, rows, st, b=None) -> dict:
    """Device ms of each step of K1's, K2's, gather_normal's and K4's calls
    (K1, K2 and gather_normal on the list of live rays, K4 on its item
    list; _device_ms around each C entry called with one step, on the
    wrappers' own scratch; no launch counted), with an nn list's sample
    table and computing the samples; with b (linear tables with
    derivatives), K3's kernel on the list; the grids: K1's blocks a
    candidate and live rays a block (gather_kernels.launch_grid), K3's
    (jacobian_grid), K4's blocks and lanes; and the floor of a call, an
    empty kernel's launch through the same C path, its device and host
    ms."""
    import torch

    from helicon_tpu_torch import _build
    from helicon_tpu_torch.denovo3d import gather_kernels as gk

    out = torch.empty((listed.shape[0], listed.l3, listed.d3, listed.d3), device=x.device)
    pred = torch.empty(listed.shape, device=x.device)
    computed = dataclasses.replace(listed, sidx=None)
    parts = {f"K2 {n}": (lambda s=s: gk._backproject_cuda(listed, r, out, s))
             for n, s in gk.BACKPROJECT_STEPS.items()}
    parts["K2 whole call"] = lambda: gk._backproject_cuda(listed, r, out)
    parts["K1 zero pred"] = lambda: gk._project_cuda(listed, x, pred, None,
                                                     gk.PROJECT_STEPS["zero pred"])
    parts["K1 kernel"] = lambda: gk._project_cuda(listed, x, pred, None,
                                                  gk.PROJECT_STEPS["kernel"])
    for n, s in gk.NORMAL_STEPS.items():
        parts[f"gather_normal {n}"] = lambda s=s: gk._normal_cuda(listed, x, rows, out, s)
    parts["gather_normal whole call"] = lambda: gk._normal_cuda(listed, x, rows, out)
    if listed.sidx is not None:
        parts["K2 sums, samples computed"] = (
            lambda: gk._backproject_cuda(computed, r, out, gk.BACKPROJECT_STEPS["sums"]))
        parts["K1 kernel, samples computed"] = (
            lambda: gk._project_cuda(computed, x, pred, None, gk.PROJECT_STEPS["kernel"]))
        parts["gather_normal whole call, samples computed"] = (
            lambda: gk._normal_cuda(computed, x, rows, out))
    k = listed.shape[0]
    for n, s in gk.SYM_STEPS.items():
        parts[f"K4 {n}"] = lambda s=s: gk._sym_cuda(st, x, out, s)
    parts["K4 whole call"] = lambda: gk._sym_cuda(st, x, out)
    if b is not None:
        jout = torch.empty((k, 13), dtype=torch.float64, device=x.device)
        parts["K3 kernel"] = lambda: gk._jacobian_cuda(listed, x, b, jout)
    res = {name: _device_ms(fn, 20) for name, fn in parts.items()}
    empty = _build.load_kernels().hgp_empty
    res["floor: an empty launch, device"] = _device_ms(lambda: gk._run(x.device, empty), 20)
    res["floor: an empty launch, host"] = _host_ms(lambda: gk._run(x.device, empty), 20)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if b is not None:
        res["K3 blocks_a_candidate"], res["K3 rays_a_block"] = gk.jacobian_grid(
            k, listed.n_max, sms)
    *_, res["K4 blocks_a_candidate"], res["K4 lanes_a_voxel"] = gk._sym_plan(st)[2]
    per, rpb = gk.launch_grid(listed.shape[0], listed.n_max, True,
                              torch.cuda.get_device_properties(x.device).multi_processor_count)
    res.update(blocks_a_candidate=per, rays_a_block=rpb)
    return res


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
    bound and its yardstick (_hold_gather); then one whole Gauss-Newton
    step at the candidate's tilt-3 pose, timed."""
    import numpy as np
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
    # K3 as refinement calls it: a whole Gauss-Newton step at the pose
    # (the linear tables with derivatives, K1's row validity and the list of
    # live rays, K3, the damped 3 x 3 solve and its copy to the host)
    from helicon_tpu_torch.denovo3d import refine

    step = (geom, np.random.default_rng(12).random((geom.d2, geom.l2)).astype(np.float32),
            np.float32([tw]), np.float32([rp]), tuple(np.asarray(c)[None] for c in copies), x,
            np.float32([[3.0, 0.0, 0.0]]))
    refine.gn_step(*step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        refine.gn_step(*step)
    ms = (time.perf_counter() - t0) * 1e3 / 20
    rows[("jacobian", "linear")]["gn_step_ms"] = ms
    print(f"phase 10 (a) [one Gauss-Newton step at tilt 3 deg, the list at its pose included]: "
          f"{ms:.4f} ms a step (host clock; the step copies its result to the host); {card}",
          flush=True)
    return rows


def phase_sym_share(device, tilted, card) -> dict:
    """Phase 10 (a), last: the share of the symmetry term in one refine
    matvec PT(rows * P(x)) + ST(S(x)) (gather_normal and K4) at tilt 3 deg (nn) on the golden
    grid's tables, for one candidate and for the 45 a refine_mode="all"
    launch takes: K4 (ST(S(x)) in one call) beside the torch S + ST it
    replaced (the taps computed at the build), and K4 held bit for bit
    against its plain version at both k."""
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
        got = ops["STS"](x)
        with _plain_gather():
            want = ops["STS"](x)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 10 (a): K4 at k={k} differs from plain by "
                                 f"{float((got - want).abs().max())}")
        ms_k4 = _time_ms(lambda: ops["STS"](x), 10)
        ms_torch = _time_ms(lambda: ops["ST"](ops["S"](x)), 10)
        ms_mv = _time_ms(lambda: ops["PTRP"](x, rows) + ops["STS"](x), 10)
        out[k] = dict(sym_ms=ms_k4, torch_sym_ms=ms_torch, matvec_ms=ms_mv,
                      share=ms_k4 / ms_mv)
        print(f"phase 10 (a) [the symmetry term, nn, tilt 3 deg, k={k}, {tabs[3].shape[1]} pair "
              f"slots]: K4 {ms_k4:.3f} ms of a {ms_mv:.3f} ms refine matvec "
              f"({100 * ms_k4 / ms_mv:.1f} %), equal to plain bit for bit; torch S + ST "
              f"{ms_torch:.3f} ms; {card}",
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
    if not all(launches[n] > 0 for n in ("gather_project", "gather_backproject", "gather_normal",
                                         "sample_table", "sym_normal")):
        raise AssertionError("phase 10 (b): the tilted search did not launch K1 / K2 / "
                             "gather_normal / sample_table / K4")


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

    from helicon_tpu_torch.denovo3d import gather_kernels as gk
    from helicon_tpu_torch.denovo3d.refine import _pose_bounds

    tw, ri = _real_size_grid()
    _zero(gk.launches)
    with _spied_refinements() as calls:
        res, b1, wall, peak = _search(device, tw, ri, return_best_volume=True,
                                      refine_tilt_psi_dy_range=REFINE_RANGE)
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

    held = _hold_refine_call(device, calls[0], pose, "phase 10 (c)", card)
    return dict(wall=wall, launches=launches, pose=pose, search_s=e["search_s"],
                refine_s=e["refine_s"], resolve_s=e["resolve_s"], **held)


@contextlib.contextmanager
def _spied_refinements():
    """Every refine.refine_tilt_psi_dy call (its arguments) made inside."""
    from helicon_tpu_torch.denovo3d import refine

    calls, real = [], refine.refine_tilt_psi_dy

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    refine.refine_tilt_psi_dy = spy
    try:
        yield calls
    finally:
        refine.refine_tilt_psi_dy = real


def _hold_refine_call(device, call, pose, phase: str, card) -> dict:
    """At the tables of one refine_tilt_psi_dy call (its arguments, as a
    search made it; tilt 0, the refined candidate's copies and pairs):
    K1-K4 against plain (nn, the solve's; linear, the Gauss-Newton step's);
    one Gauss-Newton step from the start on the kernels and on plain (new
    pose within 1e-4, r^T r within 1e-4 relative); and the whole
    refinement on the kernels (equal to the search's ``pose``) and on plain
    (poses within 5e-3, the scores at them within 5e-4)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.denovo3d import refine
    from helicon_tpu_torch.denovo3d.solver import solve_candidate

    ((geom, cfg, region, c_tw, c_rp, copies, pairs, *start, r_range), kw) = call
    start = np.float32(start)
    label = (f"{phase} [the refined candidate's tables: tilt 0, C={len(copies[0])} copy "
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
        raise AssertionError(f"{phase}: the Gauss-Newton step's r^T r differs by {rtr_err} "
                             f"or the step did not move ({moved})")
    # the whole refinement, and the scores at its poses
    whole, score = {}, {}
    t = {}
    for plain in (False, True):
        with _plain_gather() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            whole[plain] = np.float32(refine.refine_tilt_psi_dy(*call[0], **kw))
            t[plain] = time.perf_counter() - t0
            score[plain] = float(solve_candidate(geom, cfg, region, c_tw, c_rp, *copies, *pairs,
                                                 *whole[plain], device=device)["score"])
    if not np.array_equal(whole[False], np.float32(pose)):
        raise AssertionError(f"{phase}: the refinement again gave {whole[False]}, the "
                             f"search {pose}")
    _pose_gate(f"{label} the whole refinement ({t[False]:.3f} s on the kernels, {t[True]:.3f} s "
               f"plain)", whole[False], whole[True], card, score=(score[False], score[True]))
    return dict(step_moved=moved, kernel_s=t[False], plain_s=t[True])


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


# ---------------------------------------------------------------------------
# phase 11: the batch CLI as a user runs it, and two processes on one card
# ---------------------------------------------------------------------------

CLI = [sys.executable, "-m", "helicon_tpu_torch.commands.denovo3d_cli"]
# phase 4's grid (2,327 candidates) and phase 8 (a)'s (5,907) as CLI flags
CLI_GRID = "--apix 2 --twist 0.5 45 0.25 --rise 4 5 0.08 --handedness left --tubeDiameter 110"
# phase 11 (d) at phase 8 (a)'s iterations (the bench's), not the CLI's
# 100 / 40; in float32 and in the CLI's default bfloat16: a process's slice
# of a bucket holds other twist groups (fewer rises each) than the
# one-process run, and bf16 sums of other shapes move scores by ~2e-4 (C9;
# 2.65e-4 with the same top-10 on the card), so the split itself is held
# at 1e-4 in float32 and bf16 at its own 1e-3
CLI_WIDE = ("--apix 2 --twist 0.5 45 0.25 --rise 2 10 0.25 --handedness left --tubeDiameter 110 "
            "--cgIters 10 --fistaIters 16")
GATHER_KERNELS = ("gather_project", "gather_backproject", "gather_normal", "sample_table",
                  "pose_jacobian", "sym_items", "sym_normal")


def _cli(workdir: Path, argv: str, env=None, timeout=900):
    """Run the port's CLI in workdir as a user does; fails (printing its
    output) unless it exits 0. Returns (wall s, stdout, the verbose
    effective line as a dict)."""
    import os

    t0 = time.perf_counter()
    out = subprocess.run([*CLI, *argv.split()], cwd=workdir, capture_output=True, text=True,
                         timeout=timeout, env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})))
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        print(out.stdout[-6000:], out.stderr[-6000:], sep="\n", flush=True)
        raise AssertionError(f"phase 11: the CLI exited {out.returncode}: {argv}")
    return wall, out.stdout, _effective(out.stdout)


def _effective(stdout: str) -> dict:
    """The CLI's verbose effective line (the last search's)."""
    line = [x for x in stdout.splitlines() if x.startswith("effective: ")][-1]
    return json.loads(line[len("effective: "):])


def _csv_rows(path: Path):
    rows = [x.split(",") for x in path.read_text().splitlines()[1:]]
    return [(r[0], r[1]) for r in rows], [float(r[2]) for r in rows]


def _in_process(stack: Path, argv: str, device):
    """reconstruct_grid with exactly the keyword arguments the CLI passes
    for argv (its own plan and keywords), on the first image; returns
    (result, wall s)."""
    import argparse

    import torch

    from helicon_tpu_torch.commands import denovo3d_cli
    from helicon_tpu_torch.denovo3d import reconstruct_grid
    from helicon_tpu_torch.io.mrc import read_image_2d

    args = denovo3d_cli.add_args(argparse.ArgumentParser()).parse_args(
        [str(stack), "unused", *argv.split()])
    apix, indices, tw, ri, rr = denovo3d_cli.search_plan(args)
    kw = denovo3d_cli.search_kwargs(args, apix, tw, ri, rr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = reconstruct_grid(read_image_2d(stack, indices[0] - 1), **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _csv_text(res) -> str:
    """The CLI's .csv of a result (its format)."""
    import numpy as np

    return "".join(f"{res.twists[i]:.4f},{res.rises[i]:.4f},{res.scores[i]:.6f}\n"
                   for i in np.argsort(-res.scores))


def phase_cli(device, card) -> dict:
    """Phase 11 (a)-(c): the port's CLI as a subprocess on a two-image
    .mrcs stack (the amyloid twice, 2 A/px, the port's write_mrc), with the
    CLI's own defaults beyond the grid flags: (a) phase 4's grid, its .csv
    against an in-process reconstruct_grid with exactly the CLI's keyword
    arguments (the same order, scores within 1e-5; whether bit for bit is
    printed), with the subprocess's wall, the search's wall inside it, the
    first-call costs, candidates/s, top-1 and the kernels' launches; (b)
    the same with --refineTiltPsiDy 5 5 2, its refined poses (its verbose
    line) equal to the in-process call's, and the .json's the winner's;
    (c) --imageIndex 0: .batch.json with two equal rows."""
    import numpy as np
    import torch

    from helicon_tpu_torch.io.mrc import write_mrc

    work = ROOT / "build" / "phase11"
    work.mkdir(parents=True, exist_ok=True)
    stack = work / "amyloid2.mrcs"
    img = np.load(AMYLOID).astype(np.float32)
    write_mrc(stack, np.stack([img, img]), apix=2.0)
    torch.cuda.empty_cache()
    out = {}
    for key, extra in (("a", ""), ("b", "--refineTiltPsiDy 5 5 2")):
        argv = f"{stack.name} out_{key} --imageIndex 1 {CLI_GRID} {extra}".strip()
        wall, stdout, eff = _cli(work, argv)
        # twice: the first call in this process pays this configuration's
        # first-call costs too (the prep's), the second is warm
        _, first = _in_process(stack, argv.split(" ", 2)[2], device)
        with _spied_refinements() as refine_calls:
            res, warm = _in_process(stack, argv.split(" ", 2)[2], device)
        order, scores = _csv_rows(work / f"out_{key}.csv")
        want_order = [(f"{res.twists[i]:.4f}", f"{res.rises[i]:.4f}")
                      for i in np.argsort(-res.scores)]
        want = [float(f"{res.scores[i]:.6f}") for i in np.argsort(-res.scores)]
        err = float(np.abs(np.float64(scores) - np.float64(want)).max())
        bits = (work / f"out_{key}.csv").read_text() == (
            "twist_degree,rise_angstrom,score\n" + _csv_text(res))
        summary = json.loads((work / f"out_{key}.json").read_text())
        n = summary["n_candidates"]
        la = eff["launches"]
        b2 = la["solve_candidate"] + la["candidate_matvec"]
        print(f"phase 11 ({key}) [the CLI, {n} candidates{', ' + extra if extra else ''}]: "
              f"subprocess {wall:.3f} s start to exit, search {eff['wall_s']:.3f} s inside it "
              f"(Timer), {n / eff['wall_s']:.1f} candidates/s; the same call in process "
              f"{first:.3f} s, again {warm:.3f} s (warm), so first-call costs "
              f"{eff['wall_s'] - warm:.3f} s in the "
              f"search and {wall - eff['wall_s']:.3f} s around it (imports, CUDA context, the "
              f"kernel library, the files); peak {eff['peak_gib']:.2f} GiB; launches B1 "
              f"{la['group_solve']}, B2 {b2}, "
              f"{', '.join(f'{k} {la[k]}' for k in GATHER_KERNELS)}; G "
              f"{eff.get('groups_per_launch')} (in process "
              f"{res.effective.get('groups_per_launch')}); top-1 ({summary['best_twist']}, "
              f"{summary['best_rise']}) score {summary['best_score']:.6f}; .csv against the "
              f"in-process call: max |d score| {err:.2e} (limit 1e-5), "
              f"{'bit for bit as printed' if bits else 'NOT bit for bit'}; {card}", flush=True)
        if order != want_order or err > 1e-5 or la["group_solve"] <= 0:
            raise AssertionError(f"phase 11 ({key}): the CLI's ranking differs from the call "
                                 f"in process (max {err}) or B1 did not launch")
        out[key] = dict(wall=wall, search_s=eff["wall_s"], warm_s=warm, launches=la,
                        rate=n / eff["wall_s"], bits=bits, err=err, summary=summary)
        if extra:
            # every refined candidate's pose, from the verbose line (the
            # .json holds the winner's, when the winner was refined)
            got = {int(k): v for k, v in eff["refined"].items()}
            want = {int(k): [float(x) for x in v] for k, v in res.refined_params.items()}
            in_json = [summary.get(k) for k in ("refined_tilt", "refined_psi",
                                                "refined_dy_pixel")]
            ok = got == want and (in_json == want.get(res.best_index, [None] * 3))
            print(f"phase 11 (b): the CLI's refined poses {got}, in process {want}: "
                  f"{'equal' if ok else 'DIFFER'}; the winner "
                  f"{'was' if res.best_index in want else 'was not'} refined (.json pose "
                  f"{in_json}); {card}", flush=True)
            if not ok or min(la[k] for k in GATHER_KERNELS) <= 0:
                raise AssertionError("phase 11 (b): the refined poses differ from the call in "
                                     "process, or a gather kernel did not launch")
            # K1-K4 and the Gauss-Newton step against plain at the tables
            # of this run's refined candidate
            ((idx, pose),) = res.refined_params.items()
            out[key]["held"] = _hold_refine_call(device, refine_calls[0], pose, "phase 11 (b)",
                                                 card)
    wall, _, _ = _cli(work, f"{stack.name} out_c --imageIndex 0 {CLI_GRID}")
    rows = json.loads((work / "out_c.batch.json").read_text())
    same = len(rows) == 2 and all(rows[0][k] == rows[1][k] for k in rows[0] if k != "image_index")
    print(f"phase 11 (c) [--imageIndex 0, two equal images]: {wall:.3f} s; .batch.json rows "
          f"{rows}: {'equal' if same else 'DIFFER'}; {card}", flush=True)
    if not same or [r["image_index"] for r in rows] != [1, 2]:
        raise AssertionError("phase 11 (c): the batch rows differ")
    return out


def _two_processes(work: Path, tail: str, dtype: str, limit: float, card) -> dict:
    """The CLI with ``tail`` (after the stack and the output name) in one
    process and in two on the one card, with the environment torchrun sets
    (both LOCAL_RANKs map to cuda:0, so each sizes its launches from half
    the free memory it sees over the two): rank 0's .csv with the one
    process's top-10 and every score within ``limit``, both ranks exiting
    0. Prints each rank's wall, candidates, B1 / B2 launches, peak memory
    and exchange time."""
    import os
    import socket

    import numpy as np

    one_wall, _, one_eff = _cli(work, f"amyloid2.mrcs wide_{dtype}_one {tail}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = [*CLI, "amyloid2.mrcs", f"wide_{dtype}_two", *tail.split()]
    procs, walls, t0 = [], [None, None], time.perf_counter()
    paths = [work / f"wide_{dtype}_two.rank{rank}.log" for rank in range(2)]
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            with open(paths[rank], "w") as f:
                procs.append(subprocess.Popen(argv, cwd=work, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        while None in walls and time.perf_counter() - t0 < 900:
            for rank, p in enumerate(procs):
                if walls[rank] is None and p.poll() is not None:
                    walls[rank] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [x.read_text() for x in paths]
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-8000:], flush=True)
            raise AssertionError(f"phase 11 (d) [{dtype}]: rank {rank} exited {p.returncode}")
    effs = [_effective(log) for log in logs]
    order1, s1 = _csv_rows(work / f"wide_{dtype}_one.csv")
    order2, s2 = _csv_rows(work / f"wide_{dtype}_two.csv")
    err = float(np.abs(np.float64(s1) - np.float64(s2)).max()) if len(s1) == len(s2) else np.inf
    top_same = order1[:10] == order2[:10]
    print(f"phase 11 (d) [{dtype}, one process, {len(s1)} candidates]: {one_wall:.3f} s start "
          f"to exit, search {one_eff['wall_s']:.3f} s, peak {one_eff['peak_gib']:.2f} GiB, "
          f"launches B1 {one_eff['launches']['group_solve']}, B2 "
          f"{one_eff['launches']['solve_candidate']}; {card}", flush=True)
    for rank, e in enumerate(effs):
        la = e["launches"]
        print(f"phase 11 (d) [{dtype}, rank {rank} of 2 on cuda:0, {e['card_processes']} "
              f"processes on its card]: {walls[rank]:.3f} s start to exit, search "
              f"{e['wall_s']:.3f} s, {e['scored']} candidates scored, launches B1 "
              f"{la['group_solve']}, B2 {la['solve_candidate']}, peak {e['peak_gib']:.2f} GiB, "
              f"{e['exchanges']} exchanges {e['exchange_s'] * 1e3:.2f} ms (waiting for the "
              f"other rank included); {card}", flush=True)
    print(f"phase 11 (d) [{dtype}]: rank 0's .csv against one process: top-10 "
          f"{'the same' if top_same else 'DIFFERENT'}, max |d score| {err:.2e} (limit "
          f"{limit:g}); peaks together {sum(e['peak_gib'] for e in effs):.2f} GiB; {card}",
          flush=True)
    if (not top_same or err > limit or min(e["launches"]["group_solve"] for e in effs) <= 0
            or any(e["card_processes"] != 2 for e in effs)):
        raise AssertionError(f"phase 11 (d) [{dtype}]: two processes differ from one, a rank "
                             "did not launch B1, or the ranks did not share the card's memory")
    return dict(one=one_eff, ranks=effs, walls=walls, err=err)


@contextlib.contextmanager
def _first_call(module, name: str):
    """module.name wrapped: yields a dict that holds its first call's
    arguments (args, kw)."""
    real, first = getattr(module, name), {}

    def wrapped(*args, **kw):
        if not first:
            first.update(args=args, kw=kw)
        return real(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield first
    finally:
        setattr(module, name, real)


def _hold_wide_launches(device, work: Path, tail: str, card) -> dict:
    """The one-process float32 search of (d) in this process, with exactly
    the CLI's keyword arguments, its first B1 launch (a first-pass bucket's,
    G groups) and its first B2 launch (a second-pass call's) each held
    against its plain version on the same card tensors: scores within 1e-4
    and x within 1e-3 relative (phase 2's and phase 5's float32 gates)."""
    import torch

    from helicon_tpu_torch.denovo3d import candidate_solve as cs
    from helicon_tpu_torch.denovo3d import group_solve as gs

    with _first_call(gs, "solve_group") as b1, _first_call(cs, "solve_candidate_kernel") as b2:
        res, wall = _in_process(work / "amyloid2.mrcs", tail, device)
    out = {}
    for name, first, kernel, plain in (("B1", b1, gs.solve_group, gs.solve_group_reference),
                                       ("B2", b2, cs.solve_candidate_kernel,
                                        cs.solve_candidate_reference)):
        if not first:
            raise AssertionError(f"phase 11 (d): the float32 search made no {name} launch")
        inp, args, kw = first["args"][0], first["args"][1:], first["kw"]
        if name == "B1":  # (x, scores; None unless the kernel scores)
            (x_k, s_k), (x_p, s_p) = kernel(inp, *args, **kw), plain(inp, *args, **kw)
        else:
            x_k, x_p = kernel(inp, *args, **kw), plain(inp, *args, **kw)
            s_k = s_p = None
        torch.cuda.synchronize()
        x_rel = float((x_k - x_p).abs().max() / x_p.abs().max().clamp_min(1e-30))
        s_err = None if s_k is None else float((s_k - s_p).abs().max())
        if name == "B1" and s_err is None:
            raise AssertionError("phase 11 (d): the float32 B1 launch returned no scores")
        print(f"phase 11 (d) [float32, in process, {wall:.3f} s: its first {name} launch, "
              f"{inp.a_top.dtype}, shape {tuple(inp.shape)}]: against plain x rel err "
              f"{x_rel:.3e} (limit 1e-3)"
              + ("" if s_err is None else f", score abs err {s_err:.3e} (limit 1e-4)")
              + f"; {card}", flush=True)
        if (inp.a_top.dtype != torch.float32 or not bool(torch.isfinite(x_k).all())
                or not (x_rel <= 1e-3) or (s_err is not None and not (s_err <= 1e-4))):
            raise AssertionError(f"phase 11 (d): the float32 {name} launch differs from plain "
                                 f"({x_rel}, {s_err})")
        out[name] = dict(x_rel_err=x_rel, score_abs_err=s_err, shape=tuple(inp.shape))
        del x_k, x_p
    del b1["args"], b2["args"], res
    torch.cuda.empty_cache()
    return out


def phase_cli_two_processes(device, card) -> dict:
    """Phase 11 (d): the CLI on phase 8 (a)'s wide-rise grid (5,907
    candidates, four rise buckets; its iterations, CLI_WIDE) in two
    processes on the one card against one process: in float32 (limit 1e-4)
    and in the CLI's default bfloat16 (limit 1e-3, phase 2's bf16 gate),
    then the float32 search's first B1 and B2 launches against plain."""
    work = ROOT / "build" / "phase11"
    f32 = f"--imageIndex 1 {CLI_WIDE} --computeDtype float32"
    out = dict(float32=_two_processes(work, f32, "float32", 1e-4, card),
               bfloat16=_two_processes(work, f"--imageIndex 1 {CLI_WIDE}", "bfloat16", 1e-3,
                                       card))
    out["held"] = _hold_wide_launches(device, work, f32, card)
    return out


# ---------------------------------------------------------------------------
# phase 12: the web app's compute path
# ---------------------------------------------------------------------------

# the golden's top-1 as one web-app task on the amyloid at its own pixel
# size (tube 110 A, the geometry and oversampling derived as the app does)
WEBAPP_TASK = dict(ti=0, ntasks=1, imageFile="class_avg_amyloid.npy", imageIndex=1, twist=2.0,
                   rise=4.75, rise_range=(4.75, 4.75), csym=1, tilt=0.0, tilt_range=(0.0, 0.0),
                   psi=0.0, psi_range=0.0, dy=0.0, dy_range=0.0, apix2d_orig=2.0, denoise="",
                   low_pass=-1, transpose=0, horizontalize=0, target_apix3d=-1,
                   target_apix2d=2.0, thresh_fraction=-1, positive_constraint=-1,
                   tube_length=-1, tube_diameter=110.0, tube_diameter_inner=0.0,
                   reconstruct_length=-1, sym_oversample=-1, interpolation="nn", fsc_test=0,
                   return_3d=True, score_metric="cosine", algorithm=dict(model="lsq"),
                   verbose=0)


def _counts() -> dict:
    """Every kernel's launch count (B1, B2 / B3's entries, K1-K4)."""
    from helicon_tpu_torch.denovo3d import candidate_solve as cs, gather_kernels as gk
    from helicon_tpu_torch.denovo3d import group_solve as gs

    return dict(group_solve=gs.launches, **cs.launches, **gk.launches)


def _zero_counts() -> None:
    from helicon_tpu_torch.denovo3d import candidate_solve as cs, gather_kernels as gk
    from helicon_tpu_torch.denovo3d import group_solve as gs

    gs.launches = 0
    _zero(cs.launches)
    _zero(gk.launches)


@contextlib.contextmanager
def _solve_budget(cg: int, fista: int, power: int):
    """SolveConfig's iteration defaults set to (cg, fista, power) for the
    duration (the web app sends none of its own: it solves at the
    defaults, 120 / 120 / 8)."""
    from helicon_tpu_torch.denovo3d.solver import SolveConfig

    saved = SolveConfig.__new__.__defaults__
    defaults, names = list(saved), list(SolveConfig._fields)
    for name, v in (("cg_iters", cg), ("fista_iters", fista), ("power_iters", power)):
        defaults[names.index(name)] = v
    SolveConfig.__new__.__defaults__ = tuple(defaults)
    try:
        yield
    finally:
        SolveConfig.__new__.__defaults__ = saved


@contextlib.contextmanager
def _timed_parts(parts: dict):
    """process_one_task's parts timed for the duration: the functions it
    calls by module attribute, each wrapped to add its host seconds (the
    card synchronised before and after) to ``parts``: lsq_reconstruct's
    setup (geometry, copy and pair tables, region; "tables"), its pose
    refinement ("refine") and its refine-and-solve step ("refine_solve");
    the final solve_candidates call ("solve", with its build_s / solve_s /
    score_s; the refinement's own solves are not counted there);
    apply_helical_symmetry ("sym") and transform_map ("xform")."""
    import torch

    from helicon_tpu_torch.core import transforms
    from helicon_tpu_torch.denovo3d import refine, solver

    in_refine = []

    def timed(fn, key, with_times=False):
        def run(*args, **kw):
            if with_times and not in_refine:
                kw["times"] = parts
            if key == "refine":
                in_refine.append(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                if key == "refine":
                    in_refine.pop()
                if not (with_times and in_refine):
                    parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
        return run

    spots = ((solver, "_one_candidate", "tables", False),
             (solver, "_refine_and_solve", "refine_solve", False),
             (refine, "refine_tilt_psi_dy", "refine", False),
             (solver, "solve_candidates", "solve", True),
             (transforms, "apply_helical_symmetry", "sym", False),
             (transforms, "transform_map", "xform", False))
    saved = [getattr(mod, name) for mod, name, _, _ in spots]
    for mod, name, key, with_times in spots:
        setattr(mod, name, timed(getattr(mod, name), key, with_times))
    try:
        yield
    finally:
        for (mod, name, _, _), fn in zip(spots, saved):
            setattr(mod, name, fn)


def _run_task(task, device) -> tuple:
    """One process_one_task call on the card, its counts set to 0 just
    before and read just after: (result, wall s, parts, launches, refined
    pose)."""
    import torch

    from helicon_tpu_torch.denovo3d import process_one_task, solver

    parts = {}
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _timed_parts(parts):
        got = process_one_task(**task, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return got, wall, parts, _counts(), dict(solver.lsq_reconstruct._refined_params)


def _parts_text(wall, parts) -> str:
    refine = parts.get("refine", 0.0)
    pair_tables = parts["refine_solve"] - refine - parts["solve"]
    rest = wall - parts["tables"] - parts["refine_solve"] - parts["sym"] - parts["xform"]
    return (f"task wall {wall:.3f} s; lsq_reconstruct tables {parts['tables']:.3f} s, refine "
            f"{refine:.3f} s, pair tables {pair_tables:.3f} s, solve {parts['solve']:.3f} s "
            f"(build {parts['build_s']:.3f}, solve {parts['solve_s']:.3f}, score "
            f"{parts['score_s']:.3f}); re-symmetrization {parts['sym']:.3f} s, transform_map "
            f"{parts['xform']:.3f} s; prep and display (the rest) {rest:.3f} s")


def _task_errors(got, want) -> dict:
    """A task's score error and the relative errors of rec3d and the three
    display images (x / y projections, z sections) against another run."""
    import numpy as np

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    errs = dict(score=abs(got[0] - want[0]), rec3d=rel(got[1][3][0], want[1][3][0]))
    for name, g, w in zip(("x_proj", "y_proj", "z_sections"), got[1][:3], want[1][:3]):
        errs[name] = rel(g, w)
    return errs


def phase_webapp_task(device, card) -> dict:
    """Phase 12 (a): process_one_task at the golden's top-1 in float32, at
    tilt 0 (lsq_reconstruct on B2) and with the app's refinement
    (refine_tilt 5: K1-K4). Each runs at the bench's iterations (ITERS,
    set as SolveConfig's defaults), held against the same task with
    device="cpu" (tilt 0) or on the card with K1-K4 and B2 swapped for
    their plain versions (the refinement, whose gather solves on the CPU
    take minutes): score 1e-4, rec3d and the display images 1e-3 relative;
    then at the app's own budget (SolveConfig's defaults, 120 / 120 / 8),
    timed only and checked finite. Each run is driven with every count set
    to 0 just before and read just after, and prints the task's wall (host
    clock, synchronised) and its parts (_timed_parts); then
    apply_helical_symmetry and transform_map alone on the task's volume
    (CUDA events)."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core.transforms import apply_helical_symmetry, transform_map
    from helicon_tpu_torch.denovo3d import process_one_task

    img = np.load(AMYLOID)
    out = {}
    for label, over in (("tilt 0", {}), ("refine_tilt 5", dict(tilt_range=(-5.0, 5.0)))):
        task = dict(WEBAPP_TASK, data=img, **over)
        with _solve_budget(*ITERS):
            got, wall, parts, launches, pose = _run_task(task, device)
            if over:
                with _plain_gather(), _b2_solve(plain=True):
                    want = process_one_task(**task, device=device)
                against = "plain K1-K4 and B2 on the card"
            else:
                want = process_one_task(**task, device="cpu")
                against = 'device="cpu" (plain)'
        errs = _task_errors(got, want)
        app, wall_app, parts_app, launches_app, pose_app = _run_task(task, device)
        # the re-symmetrization and the transform alone, on the task's volume
        (score, (x_proj, _, _, vols, d2, d3, l2, l3), meta) = got
        rec3d = torch.as_tensor(vols[0], device=device)
        ny, new_length = x_proj.shape
        sym_kw = dict(apix=meta[3], twist_degree=task["twist"], rise_angstrom=task["rise"],
                      csym=task["csym"], new_size=(new_length, ny, ny),
                      new_apix=task["apix2d_orig"])
        n_hsym = max(1, int(new_length * task["apix2d_orig"] / task["rise"]))
        copies = (2 * n_hsym + 1) * task["csym"]
        ms_sym = _time_ms(lambda: apply_helical_symmetry(rec3d, **sym_kw), 3)
        vol = apply_helical_symmetry(rec3d, **sym_kw)
        viz = dict(tilt=pose.get("tilt", task["tilt"]), psi=pose.get("psi", task["psi"]),
                   dy=pose.get("dy", task["dy"]) / task["apix2d_orig"])
        identity = not any(viz.values())
        ms_xf = _time_ms(lambda: transform_map(vol, **viz), 3)
        print(f"phase 12 (a) [{label}, float32, iterations {ITERS}]: {_parts_text(wall, parts)}; "
              f"d2={d2} d3={d3} l2={l2} l3={l3}, score {score:.6f}, refined pose "
              f"{pose or 'none'}; launches {launches}; {card}", flush=True)
        print(f"phase 12 (a) [{label}, float32, the app's iterations (120, 120, 8), timing "
              f"only]: {_parts_text(wall_app, parts_app)}; l3={app[1][7]}, score "
              f"{app[0]:.6f}, refined pose {pose_app or 'none'}; launches {launches_app}; "
              f"{card}", flush=True)
        print(f"phase 12 (a) [{label}]: apply_helical_symmetry {tuple(rec3d.shape)} -> "
              f"{tuple(vol.shape)}, {copies} copies, {ms_sym:.3f} ms; transform_map "
              f"{tuple(vol.shape)} at {viz}{' (the identity)' if identity else ''} "
              f"{ms_xf:.3f} ms (CUDA events, 3 calls); {card}", flush=True)
        print(f"phase 12 (a) [{label}]: against {against}: score abs err {errs['score']:.3e} "
              f"(limit 1e-4), rel err rec3d {errs['rec3d']:.3e}, x {errs['x_proj']:.3e}, y "
              f"{errs['y_proj']:.3e}, z {errs['z_sections']:.3e} (limit 1e-3)", flush=True)
        need = (GATHER_KERNELS if over
                else ("solve_candidate",))
        if any(n[k] <= 0 for n in (launches, launches_app) for k in need):
            raise AssertionError(f"phase 12 (a) [{label}]: a kernel of the path did not launch "
                                 f"({launches}, {launches_app})")
        finite = all(np.all(np.isfinite(a)) for r in (got, app) for a in (*r[1][:3], r[1][3][0]))
        if not (finite and errs["score"] <= 1e-4
                and max(v for k, v in errs.items() if k != "score") <= 1e-3):
            raise AssertionError(f"phase 12 (a) [{label}]: finite {finite}, {errs}")
        out[label] = dict(wall=wall, parts=parts, launches=launches, errs=errs, ms_sym=ms_sym,
                          ms_xform=ms_xf, copies=copies, shape=tuple(vol.shape), vol=vol,
                          task=task, wall_app=wall_app, parts_app=parts_app,
                          launches_app=launches_app)
    return out


def phase_webapp_grid(device, incremental_scores) -> dict:
    """Phase 12 (b): the workflow's run_grid_incremental on phase 4's 2,327
    candidates (no batch_size: the reference's automatic batch a launch),
    counts set to 0 just before and read just after: every snapshot
    best-first and of finite scores, done rising to 2,327, the final scores
    within 1e-6 of phase 8 (c)'s reconstruct_grid call with the same
    incremental arguments; then aborted after the first launch: its final
    snapshot aborted, done below the total, ranking only scored rows."""
    import numpy as np
    import torch

    from helicon_tpu_torch.webApps.denovo3D.workflow import run_grid_incremental

    tw, ri = _real_size_grid()
    img = np.load(AMYLOID)
    kw = dict(tube_diameter=110.0, cg_iters=10, fista_iters=16, power_iters=2, device=device,
              return_best_volume=True)
    snaps = []
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_grid_incremental(img, 2.0, tw, ri, on_progress=snaps.append, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    ordered = all([r[2] for r in p.ranked] == sorted((r[2] for r in p.ranked), reverse=True)
                  and all(np.isfinite(r[2]) for r in p.ranked) for p in snaps)
    done = [p.done for p in snaps]
    delta = float(np.abs(res.scores - incremental_scores).max())
    polls = []
    part_snaps = []
    run_grid_incremental(img, 2.0, tw, ri, on_progress=part_snaps.append,
                         should_abort=lambda: polls.append(1) or len(polls) > 1, **kw)
    final = part_snaps[-1]
    print(f"phase 12 (b) [run_grid_incremental, {len(tw)} candidates]: {wall:.3f} s wall, "
          f"{len(snaps)} snapshots (done {done[:3]} ... {done[-1]}), every snapshot best-first: "
          f"{ordered}, top-1 {snaps[-1].ranked[0]}; max |score - phase 8 (c)'s| {delta:.3e} "
          f"(limit 1e-6); launches {launches}; aborted after the first launch: "
          f"{len(part_snaps)} snapshots, final done {final.done} of {final.total}, "
          f"{len(final.ranked)} ranked rows, aborted {final.aborted}", flush=True)
    if not (ordered and done == sorted(done) and done[-1] == len(tw) and delta <= 1e-6
            and launches["group_solve"] > 0 and final.aborted and final.done < final.total
            and all(np.isfinite(r[2]) for r in final.ranked)
            and len(final.ranked) == min(final.done, 200)):
        raise AssertionError("phase 12 (b): the incremental grid's snapshots or scores are off")
    return dict(wall=wall, launches=launches, delta=delta, snapshots=len(snaps))


def phase_webapp_simulate(device, task) -> dict:
    """Phase 12 (c): the app's simulation mode, symmetrize_projection of
    (a)'s re-symmetrized volume at the app's defaults (output 5 A/px, 256 x
    128 x 128, no rotation, tilt or noise) with the volume's own twist and
    rise: a finite (1, 128, 256) stack."""
    import numpy as np
    import torch

    from helicon_tpu_torch.webApps.denovo3D.workflow import symmetrize_projection

    vol = task["vol"].cpu().numpy()
    kw = dict(apix=task["task"]["apix2d_orig"], twist_degree=task["task"]["twist"],
              rise_angstrom=task["task"]["rise"], csym=1, new_size=(256, 128, 128), new_apix=5.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proj, apix = symmetrize_projection(vol, device=device, **kw)
    wall = time.perf_counter() - t0
    print(f"phase 12 (c) [symmetrize_projection {vol.shape} at {kw}]: stack {proj.shape} "
          f"{proj.dtype}, {apix} A/px, finite {bool(np.all(np.isfinite(proj)))}, max "
          f"{float(proj.max()):.4f}, {wall:.3f} s", flush=True)
    if proj.shape != (1, 128, 256) or not np.all(np.isfinite(proj)) or not proj.max() > 0:
        raise AssertionError("phase 12 (c): the simulated stack is misshapen or not finite")
    return dict(wall=wall)


def phase_webapp_grouped_fsc(device) -> dict:
    """Phase 12 (d): fsc 2 with lreg and with ssim on the grouped path (B1's
    three solves a launch, the halves scored in torch: ROADMAP A6.6b) on 20
    twists of phase 4's grid (260 candidates), counts set to 0 just before
    and read just after the kernel run; each grouped scorer call rerun with
    the plain B1 on the same card tensors: float32 scores within 1e-4,
    bf16 within 1e-3. (elasticnet with fsc goes per candidate by the
    reference's rule: phase 9 (d) holds it on B2.)"""
    import functools

    import numpy as np

    from helicon_tpu_torch.denovo3d import grid, group_solve as gs, reconstruct_grid

    tw, ri = _real_size_grid()
    sub = np.isin(tw, np.unique(tw)[:20])
    tw, ri = tw[sub], ri[sub]
    out, total = {}, 0
    for name, opt in (("lreg", dict(algorithm=dict(model="lreg"))),
                      ("ssim", dict(score_metric="ssim"))):
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-3)):
            captured, scorer = {}, grid._grouped_scoring

            def capture(*args, **kw):
                captured.update(args=args, kw=kw)
                return scorer(*args, **kw)

            grid._grouped_scoring = capture
            _zero_counts()
            try:
                res = reconstruct_grid(np.load(AMYLOID), apix=2.0, twists=tw, rises=ri,
                                       tube_diameter=110.0, cg_iters=10, fista_iters=16,
                                       power_iters=2, fsc_test=2, compute_dtype=dtype,
                                       device=device, return_best_volume=False, **opt)
            finally:
                grid._grouped_scoring = scorer
            launches = _counts()["group_solve"]
            total += launches
            run = grid._tf32_off(scorer)
            # plain B1 with the search's own power seed (grid.POWER_SEED)
            plain = functools.partial(gs.solve_group_reference, power_seed=grid.POWER_SEED)
            s_p, _ = run(*captured["args"], **dict(captured["kw"], solve=plain))
            err = float(np.abs(res.scores - s_p).max())
            e = res.effective
            print(f"phase 12 (d) [fsc 2, {name}, {dtype}, {len(tw)} candidates, path "
                  f"{e['path']}, score in kernel {e['score_in_kernel']}]: B1 {launches} launches, "
                  f"build {e['build_s']:.3f} s, solve {e['solve_s']:.3f} s, score "
                  f"{e['score_s']:.3f} s; score abs err against plain B1 {err:.3e} "
                  f"(limit {tol:g})", flush=True)
            if (e["path"] != "grouped" or e["score_in_kernel"] or launches <= 0
                    or not np.all(np.isfinite(res.scores)) or not err <= tol):
                raise AssertionError(f"phase 12 (d) [{name}, {dtype}]: B1 differs from plain "
                                     f"by {err} or did not run the grouped path")
            out[(name, dtype)] = dict(max_abs_err=err, launches=launches)
    out["launches"] = total
    return out


# ---------------------------------------------------------------------------
# phase 13: the 3D-map commands (trueFSC, proc3d)
# ---------------------------------------------------------------------------

PH13 = ROOT / "build" / "phase13"
# an amyloid-like fibril at 1 A/px: 4.75 A rise, -1.2 deg twist, two
# protofilaments of six Gaussian blobs (sigma 1.5 A) between 30 and 50 A
# radius; each half map adds noise of std ``noise`` after a 1 px low-pass
FIBRIL = dict(n=320, apix=1.0, rise=4.75, twist=-1.2, radii=(30, 34, 38, 42, 46, 50),
              sigma=1.5, noise=0.1)
PROC3D_CHAIN = ("--fft_resample new_nx=256:new_ny=256:new_nz=256 --helical_sym "
                "twist=-1.2:rise=4.75:center_fraction=0.3 --flip_hand z --clip "
                "new_nx=200:new_ny=200:new_nz=200 --z_moving_average length=4.75")
PROC3D_CHAIN_96 = ("--fft_resample new_nx=80:new_ny=80:new_nz=80 --helical_sym "
                   "twist=-1.2:rise=4.75:center_fraction=0.3 --flip_hand z --clip "
                   "new_nx=62:new_ny=62:new_nz=62 --z_moving_average length=4.75")
TRUEFSC_CURVES = ("unmasked", "randomized-unmasked", "masked", "randomized-masked", "true")
# a trueFSC run up to the plot, for a machine without matplotlib: the
# command's own parser, log and steps (trueFSC.run), and its result line
TRUEFSC_NO_PLOT = """
import sys
from argparse import ArgumentParser
from helicon_tpu_torch.commands import trueFSC as t
args = t.add_args(ArgumentParser()).parse_args(sys.argv[1:])
with t.log_to(args):
    out = t.run(args)
print(f"trueFSC resolution at FSC=0.143: {out['res_true']:.2f} A")
"""


def _fibril(n: int, device, f=FIBRIL):
    """The fibril map (n, n, n) float32 on device, one layer's slab at a time."""
    import math

    import torch

    vol = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    ax = (torch.arange(n, dtype=torch.float32, device=device) - n // 2) * f["apix"]
    span = int(math.ceil(4 * f["sigma"] / f["apix"]))
    half = n * f["apix"] / 2
    for k in range(-int(half / f["rise"]) - 1, int(half / f["rise"]) + 2):
        zc = k * f["rise"]
        iz = int(round(zc / f["apix"])) + n // 2
        z0, z1 = max(0, iz - span), min(n, iz + span + 1)
        if z0 >= z1:
            continue
        th = [math.radians(f["twist"] * k + 7.0 * j + 180.0 * p)
              for p in (0, 1) for j in range(len(f["radii"]))]
        rr = [r for _ in (0, 1) for r in f["radii"]]
        yc = torch.tensor([r * math.sin(t) for r, t in zip(rr, th)], device=device)
        xc = torch.tensor([r * math.cos(t) for r, t in zip(rr, th)], device=device)
        dz2 = (ax[z0:z1] - zc) ** 2
        d2 = (dz2[None, :, None, None] + (ax[None, None, :, None] - yc[:, None, None, None]) ** 2
              + (ax[None, None, None, :] - xc[:, None, None, None]) ** 2)
        vol[z0:z1] += torch.exp(-d2 / (2 * f["sigma"] ** 2)).sum(0)
    return vol


def _half_maps(vol, seed: int, std: float = FIBRIL["noise"]):
    """The two half maps: vol plus independent seeded noise (std ``std``
    after a Gaussian low-pass of 1 px), each on vol's device."""
    import torch

    n = vol.shape[0]
    gen = torch.Generator(device=vol.device).manual_seed(seed)
    k = torch.fft.fftfreq(n, device=vol.device)
    kr = torch.fft.rfftfreq(n, device=vol.device)
    g = torch.exp(-2 * (torch.pi * 1.0) ** 2 * (k[:, None, None] ** 2 + k[None, :, None] ** 2
                                                + kr[None, None, :] ** 2))
    out = []
    for _ in range(2):
        noise = torch.fft.irfftn(torch.fft.rfftn(torch.randn(vol.shape, generator=gen,
                                                             device=vol.device)) * g, s=vol.shape)
        out.append(vol + noise * (std / noise.std()))
    return out


@contextlib.contextmanager
def _truefsc_parts(parts: dict):
    """trueFSC's parts timed for the duration, each call's host seconds (the
    card synchronised before and after) appended to parts[key]: the FSCs,
    the phase randomizations and their random draws, the lowpass, the
    threshold, the seeds, the growth (its dilations in parts["grow_iters"]),
    each distance transform, the per-shell FSCs and each evaluation of the
    soft-edge search's objective."""
    import scipy.optimize
    import torch

    from helicon_tpu_torch import _jax_random
    from helicon_tpu_torch.core import analysis, filters, mask3d

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts.setdefault(key, []).append(time.perf_counter() - t0)
            if key == "grow":
                parts.setdefault("grow_iters", []).append(out[1])
            return out
        return run

    def minimize_scalar(fun, *args, **kw):
        return saved_min(timed(fun, "objective"), *args, **kw)

    def otsu(volume, n_bins=256, ignore_zero=True):
        # the largest bin of Otsu's histogram, counted exactly (ROADMAP
        # C13: the reference's float32 counts stop at 2^24)
        v = torch.as_tensor(volume).to(torch.float32).reshape(-1)
        lo, hi = v.min(), v.max()
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        bins = torch.clamp(((v - lo) / span * n_bins).to(torch.int32), 0, n_bins - 1)
        if ignore_zero:
            bins = bins[v != 0]
        parts.setdefault("otsu_largest_bin", []).append(
            int(torch.bincount(bins, minlength=n_bins).max()))
        return saved_otsu(volume, n_bins, ignore_zero)

    spots = ((analysis, "calc_fsc", "calc_fsc"),
             (analysis, "calc_fsc_per_shell", "calc_fsc_per_shell"),
             (filters, "randomize_phases_lowpass", "randomize"),
             (_jax_random, "uniform_tensor", "draw"),
             (mask3d, "gaussian_lowpass_3d", "lowpass"),
             (mask3d, "_threshold", "threshold"),
             (mask3d, "_top_seeds", "seeds"),
             (mask3d, "_grow", "grow"),
             (mask3d, "euclidean_distance_outside", "distance"))
    saved = [getattr(mod, name) for mod, name, _ in spots]
    saved_min, saved_otsu = scipy.optimize.minimize_scalar, mask3d.otsu_threshold_3d
    for mod, name, key in spots:
        setattr(mod, name, timed(getattr(mod, name), key))
    scipy.optimize.minimize_scalar = minimize_scalar
    mask3d.otsu_threshold_3d = otsu
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(spots, saved):
            setattr(mod, name, fn)
        scipy.optimize.minimize_scalar = saved_min
        mask3d.otsu_threshold_3d = saved_otsu


def _truefsc_in_process(work: Path, device: str, seed: int, parts=None) -> dict:
    """trueFSC.run (everything the command does up to the plot) in this
    process on the half maps in work's parent, its files in work, numpy's
    global generator seeded first; returns its result with its wall seconds
    and the peak device memory (GiB)."""
    import argparse

    import numpy as np
    import torch

    from helicon_tpu_torch.commands import trueFSC

    work.mkdir(parents=True, exist_ok=True)
    args = trueFSC.add_args(argparse.ArgumentParser()).parse_args(
        [str(work.parent / "h1.mrc"), str(work.parent / "h2.mrc"), str(work / "fsc.png"),
         "--verbose", "0", "--device", device])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    np.random.seed(seed)
    t0 = time.perf_counter()
    with trueFSC.log_to(args), (_truefsc_parts(parts) if parts is not None
                                else contextlib.nullcontext()):
        out = trueFSC.run(args)
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _curves(work: Path) -> dict:
    import numpy as np

    return {c: np.loadtxt(work / f"fsc.{c}.txt") for c in TRUEFSC_CURVES}


def _parts_line(parts: dict) -> str:
    def fmt(v):
        return (f"{v[0]:.3f}" if len(v) == 1 else
                f"{sum(v):.3f} ({len(v)} calls: " + ", ".join(f"{x:.3f}" for x in v) + ")")

    line = "; ".join(f"{k} {fmt(v)} s" for k, v in parts.items()
                     if k not in ("grow_iters", "otsu_largest_bin"))
    return line + (f"; growth dilations {parts['grow_iters']}" if "grow_iters" in parts else "")


def phase_truefsc(device, card) -> dict:
    """Phase 13 (a), (b): trueFSC at its defaults (refineMask 1, oneMask 1,
    the automatic cutoff) on the 320^3 half-map pair at 1 A/px, as a
    subprocess with --device cuda (its wall start to exit), then in this
    process with its parts timed (the card synchronised around each), its
    peak device memory and the true FSC's 0.143 resolution, and the random
    draw of a map's phases on the card against the numpy threefry (bit for
    bit, both timed); then the same command on the pair's central 128^3 with
    --device cuda and --device cpu under one numpy seed: the five curves
    within 1e-4, the masks' differing voxels counted, and a map's
    phase-randomized inverse (map1r) on the card within 1e-5 relative of
    the CPU's."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from helicon_tpu_torch import _jax_random
    from helicon_tpu_torch.core.filters import randomize_phases_lowpass
    from helicon_tpu_torch.io.mrc import read_mrc, write_mrc

    n, apix = FIBRIL["n"], FIBRIL["apix"]
    work = PH13 / "a"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    vol = _fibril(n, device)
    h1, h2 = _half_maps(vol, 13)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    for name, h in (("h1", h1), ("h2", h2)):
        write_mrc(work / f"{name}.mrc", h.cpu().numpy(), apix=apix)
    del vol
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    cmd = ([sys.executable, "-m", "helicon_tpu_torch.commands.trueFSC"] if has_mpl
           else [sys.executable, "-c", TRUEFSC_NO_PLOT])
    print(f"phase 13: matplotlib {'present: trueFSC runs whole' if has_mpl else 'absent: trueFSC runs up to the plot (trueFSC.run), its result line printed by the caller'}; "
          f"the {n}^3 pair made on the card in {t_make:.3f} s", flush=True)
    t0 = time.perf_counter()
    sub = subprocess.run([*cmd, "h1.mrc", "h2.mrc", "fsc.png", "--device", "cuda",
                          "--verbose", "1"], cwd=work, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall_sub = time.perf_counter() - t0
    if sub.returncode != 0:
        print(sub.stdout[-6000:], sub.stderr[-6000:], sep="\n", flush=True)
        raise AssertionError(f"phase 13 (a): trueFSC exited {sub.returncode}")
    res_line = [x for x in sub.stdout.splitlines() if x.startswith("trueFSC resolution")]
    print(f"phase 13 (a) [trueFSC {n}^3 at {apix} A/px, defaults, subprocess --device cuda]: "
          f"wall start to exit {wall_sub:.3f} s; {res_line[-1] if res_line else 'no result'}; "
          f"{card}", flush=True)
    sub_curves = _curves(work)

    parts = {}
    got = _truefsc_in_process(work / "in_process", "cuda", 13, parts)
    curves = _curves(work / "in_process")
    # the unmasked curve draws nothing (the subprocess's phases are its own)
    err_sub = float(np.abs(curves["unmasked"] - sub_curves["unmasked"]).max())
    print(f"phase 13 (a) [in process]: wall {got['wall']:.3f} s, peak device memory "
          f"{got['peak_gib']:.3f} GiB, cutoff {got['cutoff_res']} A, true FSC 0.143 at "
          f"{got['res_true']:.2f} A, the unmasked curve against the subprocess's {err_sub:.3e}; "
          f"parts: "
          f"{_parts_line(parts)}", flush=True)
    bins = parts.get("otsu_largest_bin")
    print("phase 13 (a) [ROADMAP C13]: " + (
        "Otsu not called (a threshold option chose the level)" if not bins else
        f"Otsu's largest bin holds {max(bins)} voxels a call ({len(bins)} calls), "
        f"{'past' if max(bins) > 2**24 else 'below'} 2^24 = {2**24}: the reference's float32 "
        f"counts {'saturate there' if max(bins) > 2**24 else 'are exact'}"), flush=True)
    ok = all(np.all(np.isfinite(v)) and v.shape == (n // 2, 2) for v in curves.values())
    if not ok or not 2 * apix < got["res_true"] < 999 or not res_line or err_sub > 1e-4:
        raise AssertionError("phase 13 (a): trueFSC's curves are not finite, misshapen, never "
                             "cross 0.143, or differ from the subprocess's")

    # the random draw of one map's phases: numpy threefry against the card's
    shape = (n, n, n // 2 + 1)
    key = _jax_random.PRNGKey(13)
    t0 = time.perf_counter()
    want = _jax_random.uniform(key, shape, 0.0, 2 * np.pi)
    t_np = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draw = _jax_random.uniform_tensor(key, shape, 0.0, 2 * np.pi, device=device)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    same = np.array_equal(draw.cpu().numpy().view(np.uint32), want.view(np.uint32))
    print(f"phase 13 (a) [the random draw, {int(np.prod(shape)):,} words]: numpy threefry "
          f"{t_np:.3f} s, on the card {t_dev:.3f} s, equal bit for bit {same}", flush=True)
    if not same:
        raise AssertionError("phase 13 (a): the card's random draw differs from numpy's")
    del draw, want

    # (b) the central 128^3 on the card and on the CPU
    m = 128
    cut = slice(n // 2 - m // 2, n // 2 + m // 2)
    work_b = PH13 / "b"
    work_b.mkdir(parents=True, exist_ok=True)
    for name, h in (("h1", h1), ("h2", h2)):
        write_mrc(work_b / f"{name}.mrc", h[cut, cut, cut].cpu().numpy(), apix=apix)
    del h1, h2
    torch.cuda.empty_cache()
    runs = {d: _truefsc_in_process(work_b / d, d, 7) for d in ("cuda", "cpu")}
    cv = {d: _curves(work_b / d) for d in runs}
    err_curves = {c: float(np.abs(cv["cuda"][c] - cv["cpu"][c]).max()) for c in TRUEFSC_CURVES}
    mask_name = "h1_h2.common_mask.mrc"
    mk = {d: read_mrc(work_b / d / mask_name)[0] for d in runs}
    diff = mk["cuda"] != mk["cpu"]
    binary = int(((mk["cuda"] == 1) != (mk["cpu"] == 1)).sum()
                 + ((mk["cuda"] == 0) != (mk["cpu"] == 0)).sum())
    data = read_mrc(work_b / "h1.mrc")[0]
    key = _jax_random.PRNGKey(21)
    r = {}
    for d in ("cuda", "cpu"):
        r[d] = randomize_phases_lowpass(torch.as_tensor(data, device=d), apix, 8.0,
                                        key=key).cpu().numpy()
    scale = float(np.abs(r["cpu"]).max())
    err_r = float(np.abs(r["cuda"] - r["cpu"]).max()) / scale
    print(f"phase 13 (b) [trueFSC {m}^3, cuda against cpu, one numpy seed]: wall "
          f"{runs['cuda']['wall']:.3f} / {runs['cpu']['wall']:.3f} s; resolutions "
          f"{runs['cuda']['res_true']:.2f} / {runs['cpu']['res_true']:.2f} A; curves max abs "
          f"diff {json.dumps({c: float(f'{v:.3e}') for c, v in err_curves.items()})} (limit "
          f"1e-4); common mask: {int(diff.sum())} of {diff.size} voxels differ (max "
          f"{float(np.abs(mk['cuda'] - mk['cpu']).max()):.3e}), {binary} in its inside / "
          f"outside; map1r on the card {err_r:.3e} relative of the CPU's (limit 1e-5)", flush=True)
    if max(err_curves.values()) > 1e-4 or not err_r <= 1e-5:
        raise AssertionError("phase 13 (b): trueFSC on the card differs from the CPU")
    return dict(wall_sub=wall_sub, parts=parts, res=got["res_true"], peak=got["peak_gib"],
                err_curves=err_curves, err_map1r=err_r)


def _proc3d(argv: list, cwd: Path):
    """proc3d's main in this process with its options timed by name (the
    card synchronised around each); returns {option: seconds}."""
    import argparse
    import os

    import torch

    from helicon_tpu_torch.commands import proc3d
    from helicon_tpu_torch.ops import proc3d as ops

    parser = proc3d.add_args(argparse.ArgumentParser())
    args = proc3d.check_args(parser.parse_args(argv), parser, argv)
    times = {}
    dispatch = ops.dispatch

    def timed(option_name, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dispatch(option_name, *a)
        torch.cuda.synchronize()
        times[option_name] = time.perf_counter() - t0
        return out

    ops.dispatch = timed
    cwd_before = Path.cwd()
    try:
        os.chdir(cwd)
        proc3d.main(args)
    finally:
        ops.dispatch = dispatch
        os.chdir(cwd_before)
    return times


def phase_proc3d(device, card) -> dict:
    """Phase 13 (c): proc3d on the 320^3 fibril map as a subprocess with
    --device cuda, the chain --fft_resample to 256^3, --helical_sym
    (twist -1.2, rise 4.75, center_fraction 0.3), --flip_hand z, --clip to
    200^3, --z_moving_average 4.75 A (its wall start to exit; a finite
    200^3 map at 1.25 A/px), the same command in this process with each
    option timed, and the same chain at 96^3 (the map's centre, sizes
    scaled) with --device cuda against --device cpu (1e-5 relative)."""
    import os

    import numpy as np
    import torch

    from helicon_tpu_torch.io.mrc import read_mrc, write_mrc

    n, apix = FIBRIL["n"], FIBRIL["apix"]
    work = PH13 / "c"
    work.mkdir(parents=True, exist_ok=True)
    vol = _fibril(n, device)
    write_mrc(work / "map.mrc", vol.cpu().numpy(), apix=apix)
    m = min(96, n)
    cut = slice(n // 2 - m // 2, n // 2 + m // 2)
    write_mrc(work / "map96.mrc", vol[cut, cut, cut].cpu().numpy(), apix=apix)
    del vol
    torch.cuda.empty_cache()
    argv = ["map.mrc", "out.mrc", *PROC3D_CHAIN.split(), "--device", "cuda", "--verbose", "0",
            "--force", "1"]
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "helicon_tpu_torch.commands.proc3d", *argv],
                         cwd=work, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall_sub = time.perf_counter() - t0
    if sub.returncode != 0:
        print(sub.stdout[-6000:], sub.stderr[-6000:], sep="\n", flush=True)
        raise AssertionError(f"phase 13 (c): proc3d exited {sub.returncode}")
    out_sub, apix_sub = read_mrc(work / "out.mrc")
    argv_in = ["map.mrc", "out_in.mrc", *argv[2:]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    times = _proc3d(argv_in, work)
    wall_in = time.perf_counter() - t0
    out_in, _ = read_mrc(work / "out_in.mrc")
    err_in = float(np.abs(out_in - out_sub).max() / np.abs(out_sub).max())
    print(f"phase 13 (c) [proc3d {n}^3 -> {out_sub.shape} at {apix_sub:.4f} A/px, subprocess "
          f"--device cuda]: wall start to exit {wall_sub:.3f} s; in process {wall_in:.3f} s, "
          f"options {json.dumps({k: round(v, 4) for k, v in times.items()})} s, output against "
          f"the subprocess's {err_in:.3e}; {card}", flush=True)
    if (out_sub.shape != (200, 200, 200) or abs(apix_sub - 1.25) > 1e-4
            or not np.all(np.isfinite(out_sub)) or not out_sub.max() > 0 or err_in > 1e-6):
        raise AssertionError("phase 13 (c): proc3d's map is misshapen, not finite, or differs "
                             "between runs")
    outs, t96 = {}, {}
    for d in ("cuda", "cpu"):
        t96[d] = _proc3d(["map96.mrc", f"out96_{d}.mrc", *PROC3D_CHAIN_96.split(), "--device", d,
                          "--verbose", "0", "--force", "1"], work)
        outs[d] = read_mrc(work / f"out96_{d}.mrc")[0]
    err96 = float(np.abs(outs["cuda"] - outs["cpu"]).max() / np.abs(outs["cpu"]).max())
    print(f"phase 13 (c) [the chain at {m}^3 -> {outs['cuda'].shape}]: cuda against cpu "
          f"{err96:.3e} relative (limit 1e-5); options cuda "
          f"{json.dumps({k: round(v, 4) for k, v in t96['cuda'].items()})} s, cpu "
          f"{json.dumps({k: round(v, 4) for k, v in t96['cpu'].items()})} s", flush=True)
    if not err96 <= 1e-5:
        raise AssertionError("phase 13 (c): proc3d on the card differs from the CPU")
    return dict(wall_sub=wall_sub, times=times, err96=err96)


# ---------------------------------------------------------------------------
# phase 14: curvelet denoising (proc3d --denoiseCurvelet, core/curvelet.py)
# ---------------------------------------------------------------------------

PH14 = ROOT / "build" / "phase14"
CURVELET_NOISE = dict(seed=14, std=0.3)  # numpy Gaussian noise on the fibril map
KEEP_REL = 1e-5  # a keep decision may differ only this close to its threshold
PEAK_LIMIT_GIB = 16.0


def _noisy_fibril(n: int, device):
    """Phase 13's fibril map (n^3, on device) and the map plus numpy noise
    (CURVELET_NOISE), both float32 numpy."""
    import numpy as np

    clean = _fibril(n, device).cpu().numpy()
    g = np.random.default_rng(CURVELET_NOISE["seed"])
    noise = g.standard_normal(clean.shape, dtype=np.float32) * np.float32(CURVELET_NOISE["std"])
    return clean, clean + noise


@contextlib.contextmanager
def _curvelet_parts(parts: dict):
    """core/curvelet.py's steps timed for the duration, the card
    synchronised around each call, seconds summed into parts[step] and the
    calls counted in parts[step + "_calls"]: window build, forward
    (ifftn of F U_k), medians (the MAD's two sorts), threshold (the keep
    mask), inverse (fftn and the sum over the bands), synthesis (the last
    ifftn)."""
    import torch

    from helicon_tpu_torch.core import curvelet

    names = dict(windows="_directional_bands_3d", forward="_coeffs", medians="_mad_sigma",
                 threshold="_keep", inverse="_accumulate", synthesis="_synthesis")
    saved = {k: getattr(curvelet, f) for k, f in names.items()}

    def timed(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
            parts[key + "_calls"] = parts.get(key + "_calls", 0) + 1
            return out
        return wrapper

    for k, f in names.items():
        setattr(curvelet, f, timed(k, saved[k]))
    try:
        yield parts
    finally:
        for k, f in names.items():
            setattr(curvelet, f, saved[k])


class _MaskHold:
    """The kept-mask rule between two runs of one denoiser: the first run
    (the card) records each band's magnitudes and thresholds on the host;
    the second (the CPU, the reference) holds each band against them as it
    comes. A decision may differ only within KEEP_REL relative of the
    CPU's threshold, and the thresholds agree within KEEP_REL. A
    coefficient so close to its threshold moves the output by its own
    synthesis, up to ~9 % of a 256^2 image's peak at sigma 3 (a 2e-6
    change of sigma moves the CPU's own output that far), so the hold also
    sums those contributions, delta = sum_k real(ifftn(fftn(D_k) U_k)) of
    the CPU's differing coefficients D_k (+ where only the card kept one,
    - where only the CPU did): the card's output minus delta is held to
    the CPU's."""

    def __init__(self, U, dims):
        self.U, self.dims = U, dims
        self.first, self.flips, self.bands, self.thr_err, self.delta = {}, 0, 0, 0.0, 0.0

    def record(self, k, c, mag, thr):
        self.first[(k, len(self.first))] = (mag.cpu().numpy(), thr.cpu().numpy())

    def hold(self, k, c, mag, thr):
        import numpy as np
        import torch

        key = next(key for key in self.first if key[0] == k)
        mag_a, thr_a = self.first.pop(key)
        mag, thr = mag.numpy(), np.asarray(thr.numpy())
        t = thr.reshape(thr.shape + (1,) * (mag.ndim - thr.ndim))
        ta = thr_a.reshape(t.shape)
        self.thr_err = max(self.thr_err, float(np.max(np.abs(ta - t) / np.abs(t))))
        kept_a, kept = mag_a >= ta, mag >= t
        differ = kept_a != kept
        near = np.abs(mag - t) <= KEEP_REL * np.abs(t)
        if not np.all(near[differ]):
            raise AssertionError(f"band {k}: a keep decision differs away from the threshold")
        self.bands += 1
        if differ.any():
            self.flips += int(differ.sum())
            sign = torch.as_tensor(kept_a.astype(np.float32) - kept.astype(np.float32))
            D = torch.fft.fftn(c * sign, dim=self.dims) * self.U[k]
            self.delta = self.delta + torch.fft.ifftn(D, dim=self.dims).real.numpy()


def phase_curvelet(device, card) -> dict:
    """Phase 14 (a)-(e): see the module docstring."""
    import argparse
    import functools
    import os

    import numpy as np
    import torch

    from helicon_tpu_torch.commands import proc3d
    from helicon_tpu_torch.core import curvelet
    from helicon_tpu_torch.io.mrc import read_mrc, write_mrc

    n, apix = FIBRIL["n"], FIBRIL["apix"]
    card_dev = device.type  # "cuda"; the CPU is the reference
    work = PH14
    work.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()
    clean, noisy = _noisy_fibril(n, device)
    write_mrc(work / "noisy.mrc", noisy, apix=apix)
    argv = ["noisy.mrc", "out.mrc", "--denoiseCurvelet", "sigma=3", "--device", card_dev,
            "--verbose", "0", "--force", "1"]

    # (a) the command as a user runs it
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "helicon_tpu_torch.commands.proc3d", *argv],
                         cwd=work, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall_sub = time.perf_counter() - t0
    if sub.returncode != 0:
        print(sub.stdout[-6000:], sub.stderr[-6000:], sep="\n", flush=True)
        raise AssertionError(f"phase 14 (a): proc3d exited {sub.returncode}")
    out_sub, apix_sub = read_mrc(work / "out.mrc")

    def mse(a):
        return float(np.mean((np.asarray(a, np.float64) - clean) ** 2))

    print(f"phase 14 (a) [proc3d --denoiseCurvelet sigma=3 on the {n}^3 fibril map + numpy "
          f"noise of std {CURVELET_NOISE['std']}, subprocess --device {card_dev}]: wall start to exit "
          f"{wall_sub:.3f} s; mean squared error to the clean map {mse(noisy):.6e} before, "
          f"{mse(out_sub):.6e} after; {card}", flush=True)
    if (out_sub.shape != noisy.shape or abs(apix_sub - apix) > 1e-4
            or not np.all(np.isfinite(out_sub)) or np.array_equal(out_sub, noisy)):
        raise AssertionError("phase 14 (a): the denoised map is misshapen, not finite or "
                             "unchanged")

    # (b) the same command in this process, its steps timed
    curvelet._directional_bands_3d.cache_clear()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30  # by earlier phases of this process
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    argv_in = ["noisy.mrc", "out_in.mrc", *argv[2:]]
    with _curvelet_parts(parts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        times = _proc3d(argv_in, work)
        wall_in = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    out_in, _ = read_mrc(work / "out_in.mrc")
    err_in = float(np.abs(out_in - out_sub).max() / np.abs(out_sub).max())
    U, meta = curvelet.curvelet_bands_3d((n, n, n), device=device)
    steps = {k: round(v, 4) for k, v in parts.items() if not k.endswith("_calls")}
    calls = {k[:-6]: v for k, v in parts.items() if k.endswith("_calls")}
    steps["other"] = round(times["denoiseCurvelet"] - sum(steps.values()), 4)
    print(f"phase 14 (b) [the same command in process]: wall {wall_in:.3f} s, the option "
          f"{times['denoiseCurvelet']:.4f} s; steps {json.dumps(steps)} s, calls "
          f"{json.dumps(calls)}; {len(meta)} bands; peak device memory {peak:.3f} GiB (limit "
          f"{PEAK_LIMIT_GIB}), {held:.3f} GiB of it held before the command; output against "
          f"the subprocess's {err_in:.3e}; {card}", flush=True)
    if len(meta) != 37 or U.shape[0] != 37 or not peak < PEAK_LIMIT_GIB or err_in > 1e-6:
        raise AssertionError("phase 14 (b): bands, peak memory or a repeat run off")

    # (c) the tight frame at full size
    s = torch.zeros((n, n, n), dtype=torch.float64, device=device)
    for k in range(U.shape[0]):
        s += U[k].double() ** 2
    covered = s > 1e-20
    frame_err = float((s[covered] - 1).abs().max())
    holes = int((~covered).sum())
    del s, covered
    vol = torch.as_tensor(noisy, device=device)
    dims = (-3, -2, -1)
    F = torch.fft.fftn(vol, dim=dims)
    acc = None
    for k in range(U.shape[0]):
        acc = curvelet._accumulate(acc, curvelet._coeffs(F, U[k], dims), U[k], dims)
    back = curvelet._synthesis(acc, dims)
    rt_err = float((back - vol).abs().max() / vol.abs().max())
    del F, acc, back, vol, U
    print(f"phase 14 (c) [the tight frame at {n}^3, nDirs 6]: |sum_k U_k^2 - 1| max "
          f"{frame_err:.3e} (limit 1e-6) over the covered voxels, {holes} voxels uncovered; "
          f"transform and inverse with nothing thresholded {rt_err:.3e} relative (limit 1e-5); "
          f"{card}", flush=True)
    if not frame_err <= 1e-6 or not rt_err <= 1e-5:
        raise AssertionError("phase 14 (c): the windows are not a tight frame")
    curvelet._directional_bands_3d.cache_clear()
    torch.cuda.empty_cache()

    # (d) the 96^3 centre through the command, card against CPU
    m = min(96, n)
    cut = slice(n // 2 - m // 2, n // 2 + m // 2)
    write_mrc(work / "noisy96.mrc", noisy[cut, cut, cut], apix=apix)
    res_d = {}
    real = curvelet.denoise_curvelet_3d
    for label, param, n_dirs in (("nDirs 6", "sigma=3", 6), ("nDirs 0", "sigma=3:nDirs=0", 0)):
        U_cpu, _ = curvelet.curvelet_bands_3d((m, m, m), n_dirs=n_dirs, device="cpu")
        hold, outs, walls = _MaskHold(U_cpu, (-3, -2, -1)), {}, {}
        for dev_name, hook in ((card_dev, hold.record), ("cpu", hold.hold)):
            curvelet.denoise_curvelet_3d = functools.partial(real, on_band=hook)
            try:
                t0 = time.perf_counter()
                _proc3d(["noisy96.mrc", f"out96_{dev_name}.mrc", "--denoiseCurvelet", param,
                         "--device", dev_name, "--verbose", "0", "--force", "1"], work)
                walls[dev_name] = time.perf_counter() - t0
            finally:
                curvelet.denoise_curvelet_3d = real
            outs[dev_name] = read_mrc(work / f"out96_{dev_name}.mrc")[0]
        peak_cpu = np.abs(outs["cpu"]).max()
        raw = float(np.abs(outs[card_dev] - outs["cpu"]).max() / peak_cpu)
        err = float(np.abs(outs[card_dev] - hold.delta - outs["cpu"]).max() / peak_cpu)
        res_d[label] = dict(err=err, raw=raw, flips=hold.flips, bands=hold.bands,
                            thr_err=hold.thr_err)
        print(f"phase 14 (d) [proc3d --denoiseCurvelet {param} on the {m}^3 centre, cuda "
              f"against cpu, {label}]: {hold.bands} bands held, {hold.flips} keep decisions "
              f"differ (each within {KEEP_REL} of its threshold), thresholds within "
              f"{hold.thr_err:.3e}; maps within {raw:.3e} of the CPU map's peak, {err:.3e} "
              f"with the differing decisions' synthesis taken out (limit 1e-4); "
              f"walls cuda {walls[card_dev]:.3f} s, cpu {walls['cpu']:.3f} s; {card}", flush=True)
        if hold.first or hold.bands != (36 if label == "nDirs 6" else 4) or not err <= 1e-4 \
                or not hold.thr_err <= KEEP_REL:
            raise AssertionError(f"phase 14 (d) {label}: the card differs from the CPU")

    # (e) the 2D denoisers on a stack of 64 images of 256^2, card against CPU
    b, w = min(64, n), min(256, n)
    lo = n // 2 - w // 2
    stack = np.ascontiguousarray(noisy[n // 2 - b // 2 : n // 2 + b // 2, lo : lo + w, lo : lo + w])
    res_e = {}
    U2, _ = curvelet.curvelet_bands_2d((w, w), device="cpu")
    for label, fn, kw in (("denoise_curvelet_2d udct", curvelet.denoise_curvelet_2d,
                           dict(transform="udct")),
                          ("denoise_curvelet_2d mct", curvelet.denoise_curvelet_2d,
                           dict(transform="mct")),
                          ("curvelet_denoise_batch_mct", curvelet.curvelet_denoise_batch_mct,
                           dict())):
        hold, outs, walls = _MaskHold(U2, (-2, -1)), {}, {}
        for dev_name, hook in ((card_dev, hold.record), ("cpu", hold.hold)):
            x = torch.as_tensor(stack, device=dev_name)
            if dev_name == card_dev:
                fn(x[:2], **kw)  # the windows built and cached, cuFFT planned
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, on_band=hook, **kw)
            torch.cuda.synchronize()
            walls[dev_name] = time.perf_counter() - t0
            outs[dev_name] = out.cpu().numpy()
        xc = torch.as_tensor(stack, device=device)
        t0 = time.perf_counter()
        batch = fn(xc, **kw)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        # each image as it gives alone (one image a call) against its slot
        alone = max(float((fn(xc[i : i + 1], **kw) - batch[i : i + 1]).abs().max()
                          / batch[i].abs().max()) for i in (0, b // 2, b - 1))
        ref = outs["cpu"]
        peaks = np.abs(ref).max(axis=(1, 2))
        raw = float(np.max(np.abs(outs[card_dev] - ref).max(axis=(1, 2)) / peaks))
        err = float(np.max(np.abs(outs[card_dev] - hold.delta - ref).max(axis=(1, 2)) / peaks))
        res_e[label] = dict(err=err, raw=raw, flips=hold.flips, wall_cuda=wall_plain,
                            alone=alone)
        print(f"phase 14 (e) [{label}, {b} images of {w}^2, cuda against cpu]: {hold.bands} "
              f"bands held, {hold.flips} keep decisions differ (each within {KEEP_REL} of its "
              f"threshold), thresholds within {hold.thr_err:.3e}; images within {raw:.3e} of "
              f"each CPU image's peak, {err:.3e} with the differing decisions' synthesis "
              f"taken out (limit 1e-4); images 0, {b // 2}, {b - 1} alone against their "
              f"slots of the stack on the card {alone:.3e}; walls cuda {wall_plain:.3f} s ("
              f"{walls[card_dev]:.3f} s with the bands copied to the host), cpu "
              f"{walls['cpu']:.3f} s; {card}", flush=True)
        if hold.first or hold.bands != 48 or not err <= 1e-4 or not hold.thr_err <= KEEP_REL:
            raise AssertionError(f"phase 14 (e) {label}: the card differs from the CPU")
    curvelet._windows_2d.cache_clear()
    return dict(wall_sub=wall_sub, wall_in=wall_in, parts=parts, peak=peak, held=held,
                frame_err=frame_err, rt_err=rt_err, d=res_d, e=res_e)


# ---------------------------------------------------------------------------
# phase 15: helical indexing from power spectra, batched cross-correlation,
# the CTF, ptychography (helix/indexing.py, core/xcorr.py, core/ctf.py,
# core/ptycho.py) and the order-0 interpolation (ROADMAP C14)
# ---------------------------------------------------------------------------

HOST_PACKAGES = ("pandas", "sklearn", "h5py", "mrcfile", "starfile")
# (name, twist deg, rise A, csym, diameter A, ball radius A), each image
# 384^2 at 0.6 A/px, the filament axis vertical
INDEX = dict(n=200, size=384, apix=0.6, seed=15, noise=0.5, min_prominence=3.0, geometries=(
    ("amyloid", -1.2, 4.75, 1, 100.0, 3.0), ("TMV-like", 22.03, 1.408, 1, 180.0, 2.0),
    ("C3 tube", 15.0, 12.0, 3, 200.0, 4.0)))
PROMINENCE_REL = 1e-4  # a line on one side only lies this close to min_prominence
XCORR = dict(classes=100, segments=20000, size=128, planted=500, checked=(10, 500), seed=151)
CTF = dict(n=1000, size=512, apix=1.0, checked=16, seed=152)
PTYCHO = dict(scan=128, det=128, step_px=2, defocus=-600.0, epochs=5, batch=256,
              small_scan=24, small_det=64, small_batch=16, floor=0.01, tol=1e-4)


def _host_packages() -> str:
    """Which optional host packages this machine has (none imported)."""
    import importlib.util

    return json.dumps({name: importlib.util.find_spec(name) is not None
                       for name in HOST_PACKAGES})


@contextlib.contextmanager
def _timed_calls(module, names, parts: dict):
    """module's functions ``names`` timed for the duration, the card
    synchronised around each call, seconds summed into parts[name]."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for n in names:
        setattr(module, n, timed(n, saved[n]))
    try:
        yield parts
    finally:
        for n in names:
            setattr(module, n, saved[n])


def _sync_wall(fn):
    """(fn(), host seconds with the card synchronised before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _peak_gib(reset: bool = False) -> float:
    import torch

    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _index_stack(device):
    """INDEX["n"] class averages: the three geometries' projections in
    turn (the port's simulator on device), each plus seeded numpy
    Gaussian noise of INDEX["noise"] times its projection's std."""
    import numpy as np

    from helicon_tpu_torch.helix import simulate_helical_projection

    n, apix = INDEX["size"], INDEX["apix"]
    projs = [np.ascontiguousarray(np.asarray(simulate_helical_projection(
        1, tw, ri, cs, d, br, 0, 1.0, n, n, apix, rng=INDEX["seed"], device=device)).T)
        for _, tw, ri, cs, d, br in INDEX["geometries"]]
    which = np.arange(INDEX["n"]) % len(projs)
    g = np.random.default_rng(INDEX["seed"])
    scale = np.asarray([p.std() * INDEX["noise"] for p in projs], np.float32)[which, None, None]
    stack = np.stack([projs[k] for k in which])
    stack += g.standard_normal(stack.shape, dtype=np.float32) * scale
    return stack, which


def _prominences(prof, rows):
    """A row's peak height over the profile's MAD (helix/indexing.py's
    _peak_rows test), for the rows given."""
    import numpy as np
    from scipy.ndimage import median_filter

    prof = np.asarray(prof, np.float64)
    resid = prof - median_filter(prof, size=max(5, prof.shape[0] // 16))
    mad = np.median(np.abs(resid - np.median(resid))) * 1.4826 + 1e-12
    return resid[rows] / mad


def _hold_lines(got, want, prof_got, prof_want, ny: int, apix: float) -> int:
    """Two line lists of one spectrum (card, CPU): the lines on both sides
    equal (intensity within 1e-5); a line on one side only must have its
    prominence within PROMINENCE_REL of min_prominence on its side.
    Returns the count of such lines."""
    import numpy as np

    sy = np.abs(np.fft.fftshift(np.fft.fftfreq(ny, d=apix)))
    key = lambda l: (l.Z, l.meridional)  # noqa: E731
    a, b = {key(l): l for l in got}, {key(l): l for l in want}
    for k in a.keys() & b.keys():
        x, y = a[k], b[k]
        if (x.r_peak, x.bessel_order) != (y.r_peak, y.bessel_order) \
                or abs(x.intensity - y.intensity) > 1e-5:
            raise AssertionError(f"line {k}: card {x}, cpu {y}")
    alone = 0
    for side, lines, prof in (("card", a, prof_got), ("cpu", b, prof_want)):
        for k in lines.keys() - (b.keys() if side == "card" else a.keys()):
            rows = np.flatnonzero(np.abs(np.round(sy, 6) - k[0]) < 1e-9)
            prom = _prominences(prof[2] if k[1] else prof[0], rows)
            m = INDEX["min_prominence"]
            if not np.any(np.abs(prom - m) <= PROMINENCE_REL * m):
                raise AssertionError(f"line {k} only on the {side}, prominence {prom}")
            alone += 1
    return alone


def phase_indexing(device, card) -> dict:
    """Phase 15 (a): see the module docstring."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core import transforms
    from helicon_tpu_torch.helix import indexing

    import scipy.ndimage  # noqa: F401  (the peak logic's imports, outside the timed calls)
    import scipy.signal  # noqa: F401

    apix, n = INDEX["apix"], INDEX["n"]
    stack, which = _index_stack(device)
    _peak_gib(reset=True)
    x = torch.as_tensor(stack, device=device)
    # each step twice: the first call plans cuFFT's transforms for the shapes
    t_spec, t_prof, t_detect = [], [], []
    for _ in range(2):
        (pwr, _), t = _sync_wall(lambda: transforms.compute_power_spectra_batch(x, apix))
        t_spec.append(t)
        prof_card, t = _sync_wall(lambda: indexing.layer_line_profiles(pwr))
        t_prof.append(t)
        lines, t = _sync_wall(lambda: indexing.detect_layer_lines_batch(
            pwr, apix, min_prominence=INDEX["min_prominence"]))
        t_detect.append(t)
    peak = _peak_gib()
    one = {}
    for k, (name, tw, ri, cs, d, _) in enumerate(INDEX["geometries"]):
        img = x[int(np.flatnonzero(which == k)[0])]
        one[name], one[name + "_s"] = _sync_wall(lambda: indexing.estimate_helical_parameters(
            img, apix=apix, diameter=d, csym=cs))
    # the CPU
    pwr_cpu, _ = transforms.compute_power_spectra_batch(torch.as_tensor(stack), apix)
    lines_cpu = indexing.detect_layer_lines_batch(pwr_cpu, apix,
                                                  min_prominence=INDEX["min_prominence"],
                                                  device="cpu")
    spec_err = float((pwr.cpu() - pwr_cpu).abs().max())
    prof_card = [t.cpu().numpy() for t in prof_card]
    prof_cpu = [t.numpy() for t in indexing.layer_line_profiles(pwr_cpu)]
    alone = sum(_hold_lines(lines[i], lines_cpu[i], [p[i] for p in prof_card],
                            [p[i] for p in prof_cpu], pwr.shape[-2], apix) for i in range(n))
    batch_err = max(float((transforms.compute_power_spectra(x[i], apix)[0] - pwr[i]).abs().max())
                    for i in (0, n // 2, n - 1))
    tables = {}
    for k, (name, tw, ri, cs, d, _) in enumerate(INDEX["geometries"]):
        img = stack[int(np.flatnonzero(which == k)[0])]
        cpu = indexing.estimate_helical_parameters(img, apix=apix, diameter=d, csym=cs,
                                                   device="cpu")
        got, want = one[name]["candidates"], cpu["candidates"]
        same_lines = [(l.Z, l.meridional) for l in one[name]["layer_lines"]] == \
            [(l.Z, l.meridional) for l in cpu["layer_lines"]]
        if same_lines:
            strip = lambda cs_: [{k_: v for k_, v in c.items() if k_ != "support"}  # noqa: E731
                                 for c in cs_]
            if json.dumps(strip(got)) != json.dumps(strip(want)) or any(
                    abs(a["support"] - b["support"]) > 1e-4 for a, b in zip(got, want)):
                raise AssertionError(f"phase 15 (a) {name}: candidate tables differ")
        best = got[0] if got else {}
        tables[name] = dict(candidates=len(got), lines=len(one[name]["layer_lines"]),
                            same_lines=same_lines, wall_s=one[name + "_s"],
                            best={k_: best.get(k_) for k_ in ("twist", "rise", "pitch")},
                            truth=(tw, ri))
    n_lines = sum(len(l) for l in lines)
    print(f"phase 15 (a) [{n} class averages of {INDEX['size']}^2 at {apix} A/px, three "
          f"geometries + noise], first call / second: compute_power_spectra_batch "
          f"{t_spec[0]:.4f} / {t_spec[1]:.4f} s, detect_layer_lines_batch {t_detect[0]:.4f} / "
          f"{t_detect[1]:.4f} s (its profiles alone {t_prof[0]:.4f} / {t_prof[1]:.4f} s), "
          f"{n_lines} lines; peak device memory {peak:.3f} GiB; spectra within {spec_err:.3e} "
          f"of the CPU's (peak 1; limit 1e-5), an image alone against its slot {batch_err:.3e}; "
          f"lines on one side only {alone} (each within {PROMINENCE_REL} of min_prominence); "
          f"estimate_helical_parameters {json.dumps(tables)}; {card}", flush=True)
    if not spec_err <= 1e-5:
        raise AssertionError("phase 15 (a): the card's spectra differ from the CPU's")
    return dict(spectra_s=t_spec, detect_s=t_detect, profiles_s=t_prof, peak=peak,
                spec_err=spec_err, alone=alone, batch_err=batch_err, tables=tables)


def phase_xcorr(device, card) -> dict:
    """Phase 15 (b): see the module docstring."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core import xcorr

    C, S, m = XCORR["classes"], XCORR["segments"], XCORR["size"]
    g = np.random.default_rng(XCORR["seed"])
    classes = g.standard_normal((C, m, m), dtype=np.float32)
    segments = g.standard_normal((S, m, m), dtype=np.float32)
    planted = XCORR["planted"]
    cls = np.arange(planted) % C
    offs = g.integers(-20, 21, (planted, 2))
    for i in range(planted):  # a class shifted by offs[i], plus noise
        segments[i] = np.roll(classes[cls[i]], tuple(offs[i]), axis=(0, 1)) + 0.5 * segments[i]
    _peak_gib(reset=True)
    cl = torch.as_tensor(classes, device=device)
    sg = torch.as_tensor(segments, device=device)
    chunk = xcorr.segment_chunk(C, S, m, m, device)
    walls, runs = [], []
    for _ in range(2):  # the first call plans cuFFT's transforms
        parts = {}
        with _timed_calls(xcorr, ("_spectra", "_correlate", "_peaks"), parts):
            (peak, shift), wall = _sync_wall(lambda: xcorr.batched_cross_correlation(cl, sg))
        walls.append(wall)
        runs.append(parts)
    mem = _peak_gib()
    cold = runs[0]
    del sg
    c_n, s_n = XCORR["checked"]
    p_cpu, s_cpu = xcorr.batched_cross_correlation(classes[:c_n], segments[:s_n], device="cpu")
    p_card, s_card = peak[:c_n, :s_n].cpu().numpy(), shift[:c_n, :s_n].cpu().numpy()
    p_cpu, s_cpu = p_cpu.numpy(), s_cpu.numpy()
    peak_err = float(np.abs(p_card - p_cpu).max() / np.abs(p_cpu).max())
    moved = list(zip(*np.nonzero((s_card != s_cpu).any(-1))))
    for c, s in moved:
        cc = xcorr.cross_correlation_map(classes[c], segments[s]).numpy()
        if abs(cc[tuple(s_card[c, s])] - cc[tuple(s_cpu[c, s])]) > 1e-5 * abs(p_cpu[c, s]):
            raise AssertionError(f"phase 15 (b): pair ({c}, {s}) peaks apart")
    own = shift[cls, torch.arange(planted)].cpu().numpy()
    want = -offs
    want = np.where(want > m // 2, want - m, np.where(want <= -(m - m // 2), want + m, want))
    planted_ok = bool(np.array_equal(own, want)) and float(
        peak[cls, torch.arange(planted)].min()) > 0.8
    pairs = C * S
    # the three passes over the (C, chunk, m, m) product: its half spectrum
    # written and read by the inverse FFT, the maps written and read by the max
    passes_gb = pairs * (2 * m * (m // 2 + 1) * 8 + 2 * m * m * 4) / 1e9
    print(f"phase 15 (b) [batched_cross_correlation, {C} classes x {S} segments of {m}^2, "
          f"{pairs} pairs, chunks of {chunk} segments], second call (first): wall {wall:.4f} s "
          f"({walls[0]:.4f}), {pairs / wall:.0f} pairs/s: spectra {parts['_spectra']:.4f} s "
          f"({cold['_spectra']:.4f}), products + inverse FFTs {parts['_correlate']:.4f} s "
          f"({cold['_correlate']:.4f}), peaks {parts['_peaks']:.4f} s ({cold['_peaks']:.4f}); "
          f"the passes over the products move {passes_gb:.1f} GB ({passes_gb / 3350:.4f} s at "
          f"3.35 TB/s); peak device memory {mem:.3f} GiB; {c_n} x {s_n} pairs against the CPU: "
          f"peaks within {peak_err:.3e} relative (limit 1e-5), {len(moved)} shifts differ (each "
          f"between two peaks within 1e-5); planted shifts recovered {planted_ok}; {card}",
          flush=True)
    if not peak_err <= 1e-5 or not planted_ok:
        raise AssertionError("phase 15 (b): the card's correlations are off")
    return dict(wall=wall, wall_first=walls[0], parts=parts, parts_first=cold, peak=mem,
                peak_err=peak_err, moved=len(moved), chunk=chunk)


def _gamma_max(shape, apix, defocus_A) -> float:
    """The largest CTF phase (rad) of a shape at a defocus (300 kV)."""
    import math

    from helicon_tpu_torch.core.ctf import electron_wavelength

    return math.pi * electron_wavelength(300.0) * 2 * (0.5 / apix) ** 2 * defocus_A


def phase_ctf(device, card) -> dict:
    """Phase 15 (c): see the module docstring."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core import ctf

    n, m, apix = CTF["n"], CTF["size"], CTF["apix"]
    g = np.random.default_rng(CTF["seed"])
    du = g.uniform(5000.0, 30000.0, n).astype(np.float32)
    dv = du * np.float32(0.9)
    kw = dict(astig_angle_deg=30.0, bfactor=40.0)
    _peak_gib(reset=True)
    ctf.ctf_2d((m, m), apix, defocus_u_A=du[:2], defocus_v_A=dv[:2], device=device, **kw)
    out, wall = _sync_wall(lambda: ctf.ctf_2d((m, m), apix, defocus_u_A=du, defocus_v_A=dv,
                                              device=device, **kw))
    mem = _peak_gib()
    idx = np.sort(g.choice(n, CTF["checked"], replace=False))
    cpu = ctf.ctf_2d((m, m), apix, defocus_u_A=du[idx], defocus_v_A=dv[idx], device="cpu", **kw)
    err = float((out[torch.as_tensor(idx, device=out.device)].cpu() - cpu).abs().max())
    limit = 3 * float(np.spacing(np.float32(_gamma_max((m, m), apix, float(du[idx].max())))))
    finite = bool(torch.isfinite(out).all())
    print(f"phase 15 (c) [ctf_2d, {n} defoci 0.5-3 um at {m}^2, {out.numel() * 4 / 1e9:.2f} GB]: "
          f"wall {wall:.4f} s ({n / wall:.0f} images/s); peak device memory {mem:.3f} GiB; "
          f"{len(idx)} against the CPU within {err:.3e} (limit {limit:.3e}: 3 float32 ulps of the "
          f"largest phase, {_gamma_max((m, m), apix, float(du[idx].max())):.1f} rad); finite "
          f"{finite}; {card}", flush=True)
    if tuple(out.shape) != (n, m, m) or not finite or not err <= limit:
        raise AssertionError("phase 15 (c): the card's CTFs are off")
    return dict(wall=wall, peak=mem, err=err, limit=limit)


def _ptycho_dataset(scan: int, det: int, device, floor: float = 0.0):
    """tests/test_aux_modules.py's synthetic 4D-STEM rule at (scan, det):
    a defocused hard-aperture probe (radius 8 px) over a smooth seeded
    phase object, |FFT|^2 of each position's exit wave, centred; the
    patterns on device in complex128, kept float32 on the host. floor:
    a vacuum probe of |probe_f|^2 + floor * its max (0: the fixture's).
    Returns (data, vacuum, acc_v, semiconv_mrad, r_pixel_a, V, pad_gen)."""
    import numpy as np
    import torch
    from scipy.ndimage import gaussian_filter

    from helicon_tpu_torch.core.ptycho import electron_wavelength_angstrom

    step_px, defocus = PTYCHO["step_px"], PTYCHO["defocus"]
    rng = np.random.default_rng(0)
    acc_v = 300e3
    lam = electron_wavelength_angstrom(acc_v)
    bf_r = 8.0
    q_pixel_mrad = lam / (det * 1.0) * 1e3
    ky = np.fft.fftfreq(det)[:, None] * det
    kx = np.fft.fftfreq(det)[None, :] * det
    rr = np.hypot(ky, kx)
    chi = np.pi * lam * (rr * (q_pixel_mrad * 1e-3) / lam) ** 2 * defocus
    probe_f = (rr <= bf_r) * np.exp(1j * chi)
    probe = np.fft.ifft2(probe_f)
    probe /= np.sqrt((np.abs(probe) ** 2).sum())
    oy = ox = (scan - 1) * step_px + det + 8
    V = gaussian_filter(rng.standard_normal((oy, ox)), 3)
    V = (0.6 * V / np.abs(V).max()).astype(np.float32)
    O = torch.as_tensor(np.exp(1j * V), device=device).to(torch.complex128)
    P = torch.as_tensor(probe, device=device)
    pad_gen = 4
    data = np.zeros((scan, scan, det, det), np.float32)
    for i in range(scan):
        rows = O[i * step_px + pad_gen : i * step_px + pad_gen + det]  # (det, ox)
        patches = rows.unfold(1, det, step_px)[:, pad_gen // step_px : pad_gen // step_px + scan]
        psi = P[None] * patches.permute(1, 0, 2)  # (scan, det, det)
        data[i] = torch.fft.fftshift(torch.fft.fft2(psi).abs() ** 2, dim=(-2, -1)).float().cpu()
    vacuum = np.fft.fftshift(np.abs(probe_f) ** 2)
    if floor:
        vacuum = vacuum + floor * vacuum.max()
    return data, vacuum, acc_v, bf_r * q_pixel_mrad, float(step_px), V, pad_gen


def _truth_corr(pot, V, pad_gen, scan, det, margin=10) -> float:
    """The phase's correlation with the truth over the scanned region
    (the reference's test_ptycho_reconstruct_synthetic measure)."""
    import numpy as np

    tru = np.zeros_like(pot)
    o = 16 - pad_gen
    oy, ox = (min(a, b - o) for a, b in zip(V.shape, pot.shape))
    tru[o : o + oy, o : o + ox] = V[:oy, :ox]
    span = (scan - 1) * PTYCHO["step_px"] + det
    r = pot[16 + margin : 16 + span - margin, 16 + margin : 16 + span - margin]
    t = tru[16 + margin : 16 + span - margin, 16 + margin : 16 + span - margin]
    r, t = r - r.mean(), t - t.mean()
    return float((r * t).sum() / np.sqrt((r * r).sum() * (t * t).sum()))


def phase_ptycho(device, card) -> dict:
    """Phase 15 (d): see the module docstring."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core import ptycho

    scan, det = PTYCHO["scan"], PTYCHO["det"]
    data, vacuum, acc_v, semi, r_pix, V, pad_gen = _ptycho_dataset(scan, det, device)
    seen = {}
    real_parallax = ptycho.estimate_defocus_parallax

    def spy(*a, **kw):
        seen["defocus"] = real_parallax(*a, **kw)
        return seen["defocus"]

    def run(d, vac, dev, epochs, batch, crop=16):
        return ptycho._reconstruct(d, vac, acc_v, semi, r_pix, defocus_initial_guess=-15000,
                                   com_rotation_force=0.0, com_transpose_force=False,
                                   batch_size=batch, step_size=0.5, crop_margin=crop,
                                   num_iter=epochs, device=dev)

    _peak_gib(reset=True)
    walls, runs = [], []
    ptycho.estimate_defocus_parallax = spy
    try:
        for _ in range(2):  # the first call plans cuFFT's transforms
            parts = {}
            with _timed_calls(ptycho, ("estimate_defocus_parallax", "_epie_reconstruct"), parts):
                pot, wall = _sync_wall(lambda: run(data, vacuum, device, PTYCHO["epochs"],
                                                    PTYCHO["batch"]))
            walls.append(wall)
            runs.append(parts)
    finally:
        ptycho.estimate_defocus_parallax = real_parallax
    mem = _peak_gib()
    cold = runs[0]
    finite = bool(np.isfinite(pot).all())
    corr = _truth_corr(np.pad(pot, 16), V, pad_gen, scan, det)
    n_steps = PTYCHO["epochs"] * -(-scan * scan // PTYCHO["batch"])
    print(f"phase 15 (d) [ptychography, a {scan} x {scan} scan, {det}^2 detector "
          f"({data.nbytes / 1e9:.2f} GB float32), {PTYCHO['epochs']} epochs of batch "
          f"{PTYCHO['batch']} ({n_steps} steps)], second call (first): after the loader "
          f"{wall:.3f} s ({walls[0]:.3f}): parallax {parts['estimate_defocus_parallax']:.4f} s "
          f"({cold['estimate_defocus_parallax']:.4f}), ePIE {parts['_epie_reconstruct']:.4f} s "
          f"({cold['_epie_reconstruct']:.4f}; {parts['_epie_reconstruct'] / n_steps * 1e3:.3f} ms "
          f"a step); defocus estimate "
          f"{seen['defocus']:.1f} A (truth {PTYCHO['defocus']:.1f}); phase {pot.shape} finite "
          f"{finite}, correlation with the truth {corr:.4f}; peak device memory {mem:.3f} GiB; "
          f"{card}", flush=True)
    if not finite:
        raise AssertionError("phase 15 (d): the phase is not finite")
    # the small set, card against CPU, on the floored vacuum probe (no zero
    # in its spectrum) and on the fixture's hard aperture
    small = {}
    s_scan, s_det = PTYCHO["small_scan"], PTYCHO["small_det"]
    for label, floor in (("floored vacuum probe", PTYCHO["floor"]), ("hard aperture", 0.0)):
        d, vac, *_, Vs, pg = _ptycho_dataset(s_scan, s_det, device, floor=floor)
        (a, t_card) = _sync_wall(lambda: run(d, vac, device, PTYCHO["epochs"],
                                             PTYCHO["small_batch"], crop=0))
        b = run(d, vac, device, PTYCHO["epochs"], PTYCHO["small_batch"], crop=0)
        t0 = time.perf_counter()
        c = run(d, vac, "cpu", PTYCHO["epochs"], PTYCHO["small_batch"], crop=0)
        t_cpu = time.perf_counter() - t0
        err = float(np.abs(a - c).max())
        small[label] = dict(err=err, repeat=bool(np.array_equal(a, b)), card_s=t_card,
                            cpu_s=t_cpu, corr_card=_truth_corr(a, Vs, pg, s_scan, s_det),
                            corr_cpu=_truth_corr(c, Vs, pg, s_scan, s_det))
    fl, ha = small["floored vacuum probe"], small["hard aperture"]
    print(f"phase 15 (d) [{s_scan} x {s_scan} scan, {s_det}^2 detector, {PTYCHO['epochs']} "
          f"epochs of batch {PTYCHO['small_batch']}, cuda against cpu]: floored vacuum probe "
          f"within {fl['err']:.3e} rad (limit {PTYCHO['tol']}); hard aperture {ha['err']:.3e} rad "
          f"apart (its first steps take the phase of rounding noise outside the aperture), "
          f"correlation with the truth card {ha['corr_card']:.4f} / cpu {ha['corr_cpu']:.4f}; a "
          f"second run on the card equal bit for bit: {fl['repeat']} / {ha['repeat']}; walls "
          f"cuda {fl['card_s']:.3f} s, cpu {fl['cpu_s']:.3f} s; {card}", flush=True)
    if not fl["err"] <= PTYCHO["tol"] or not (fl["repeat"] and ha["repeat"]):
        raise AssertionError("phase 15 (d): the small set differs from the CPU or does not "
                             "repeat")
    return dict(wall=wall, wall_first=walls[0], parts=parts, parts_first=cold, peak=mem,
                defocus=seen["defocus"], corr=corr, small=small)


def phase_interp(device, card) -> dict:
    """Phase 15 (e): see the module docstring."""
    import numpy as np
    import torch

    from helicon_tpu_torch.core import interp, rotation

    g = np.random.default_rng(155)
    img = g.random((97, 113)).astype(np.float32)
    coords = []
    for n in img.shape:
        c = g.uniform(-3.0, n + 2.0, (300, 400)).astype(np.float32)
        c.flat[::4] = np.floor(c.flat[::4]) + np.float32(0.5)
        coords.append(c)
    res, walls = {}, {}
    _peak_gib(reset=True)
    for mode in ("constant", "nearest", "edge", "mirror", "reflect", "wrap", "grid-wrap"):
        x, cs_ = torch.as_tensor(img, device=device), [torch.as_tensor(c, device=device)
                                                        for c in coords]
        card_out, walls[mode] = _sync_wall(lambda: interp.map_coordinates(
            x, cs_, order=0, mode=mode, cval=-1.0))
        cpu_out = interp.map_coordinates(torch.as_tensor(img), [torch.as_tensor(c) for c in coords],
                                         order=0, mode=mode, cval=-1.0)
        res[mode] = bool(torch.equal(card_out.cpu(), cpu_out))
    angles = g.uniform(-180, 180, (64, 3)).astype(np.float32)
    vecs = g.standard_normal((64, 500, 3)).astype(np.float32)
    rot = [rotation.apply_rotation(rotation.euler_matrix("ZYZ", torch.as_tensor(angles, device=dev))
                                   [:, None], torch.as_tensor(vecs, device=dev)[..., None, :])
           .cpu() for dev in (device, "cpu")]
    rot_err = float((rot[0] - rot[1]).abs().max())
    vol = g.random((40, 48, 56)).astype(np.float32)
    zyx = [g.uniform(-2.0, n + 1.0, (64, 64, 16)).astype(np.float32) for n in vol.shape]
    gat = [(interp.linear_gather_2d(torch.as_tensor(img, device=dev), *(torch.as_tensor(c, device=dev)
                                                                       for c in coords), fill=-1.0)
            .cpu(), interp.trilinear_gather_3d(torch.as_tensor(vol, device=dev),
                                               *(torch.as_tensor(c, device=dev) for c in zyx),
                                               fill=2.0).cpu()) for dev in (device, "cpu")]
    g2 = float((gat[0][0] - gat[1][0]).abs().max())
    g3 = float((gat[0][1] - gat[1][1]).abs().max())
    mem = _peak_gib()
    print(f"phase 15 (e) [map_coordinates order 0 on {img.shape}, {coords[0].size} samples, a "
          f"quarter at exact .5, cuda against cpu]: walls on the card (first call each) "
          f"{json.dumps({k: round(v, 5) for k, v in walls.items()})} s, peak device memory "
          f"{mem:.3f} GiB; bit for bit by mode {json.dumps(res)}; "
          f"apply_rotation (64 ZYZ matrices x 500 vectors) within {rot_err:.3e}; "
          f"linear_gather_2d within {g2:.3e}, trilinear_gather_3d within {g3:.3e} (limit 1e-6); "
          f"{card}", flush=True)
    if not all(res.values()) or not max(rot_err, g2, g3) <= 1e-6:
        raise AssertionError("phase 15 (e): the card's interpolation differs from the CPU's")
    return dict(order0=res, walls=walls, peak=mem, rot_err=rot_err, gather_2d=g2, gather_3d=g3)


def phase_helical_arrays(device, card) -> dict:
    """Phase 15 (a)-(e)."""
    out = {}
    for key, fn in (("a", phase_indexing), ("b", phase_xcorr), ("c", phase_ctf),
                    ("d", phase_ptycho), ("e", phase_interp)):
        t0 = time.perf_counter()
        out[key] = fn(device, card)
        out[key]["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 16: images2star on the card (commands/images2star.py and the options
# of ops/images2star/ that touch pixels), at a real project's scale
# ---------------------------------------------------------------------------

PH16 = ROOT / "build" / "phase16"
# (a) bench.py's ETL frame and chain; (b) createStack; (c) maskGold on
# micrographs with planted gold discs; (d) denoiseCurvelet; (e)
# extractHelices on (c)'s micrographs; (f) calibratePixelSize on a gold ring
I2S = dict(seed=16, rows=100_000, stacks=8, per_stack=500, size=256, rescale=128, held=16,
           mics=4, mic_size=4096, mic_apix=1.0, discs=40, disc_radius=(20.0, 40.0),
           dn_particles=500, dn_held=4, dn_mics=8, filaments=25, width=300, strips_held=4,
           cal_n=100, cal_size=512, cal_radius=217, cal_off=1.02)
ETL_CHAIN = ["--select", "rlnClassNumber", "1,2,3,4,5,6,7,8,9,10",
             "--addParm", "rlnDefocusU", "100", "--multParm", "rlnDefocusV", "1.01",
             "--sortby", "rlnMicrographName", "rlnHelicalTubeID",
             "--breakFilaments", "maxSegments=20", "--removeDuplicates", "rlnImageName"]


def _i2s_args(device, **kw):
    import argparse

    return argparse.Namespace(verbose=0, folder=[], output_starFile="out.star",
                              device=str(device), **kw)


def _i2s(option, frame, param, device):
    """One images2star option through the port's dispatch, on ``device``."""
    import collections

    from helicon_tpu_torch.ops import images2star as ops

    return ops.dispatch(option, frame, _i2s_args(device), collections.defaultdict(int),
                        param)[0]


@contextlib.contextmanager
def _cwd(path: Path):
    import os

    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def phase_i2s_etl(device, card) -> dict:
    """Phase 16 (a): see the module docstring."""
    import argparse
    import os

    import numpy as np
    import pandas as pd

    from helicon_tpu_torch.commands import images2star
    from helicon_tpu_torch.io import metadata
    from helicon_tpu_torch.ops import images2star as ops

    work = PH16 / "etl"
    work.mkdir(parents=True, exist_ok=True)
    n = I2S["rows"]
    g = np.random.default_rng(I2S["seed"])
    df = pd.DataFrame(dict(
        rlnImageName=[f"{i % 500 + 1:06d}@stack_{i // 500:04d}.mrcs" for i in range(n)],
        rlnMicrographName=[f"mic_{i // 500:04d}.mrc" for i in range(n)],
        rlnHelicalTubeID=g.integers(1, 20, n), rlnCoordinateX=g.uniform(0, 4000, n),
        rlnCoordinateY=g.uniform(0, 4000, n), rlnHelicalTrackLengthAngst=g.uniform(0, 5000, n),
        rlnDefocusU=g.uniform(8000, 30000, n), rlnDefocusV=g.uniform(8000, 30000, n),
        rlnDefocusAngle=g.uniform(0, 180, n), rlnAnglePsi=g.uniform(-180, 180, n),
        rlnClassNumber=g.integers(1, 51, n)))
    df.attrs["convention"] = "relion"
    for k in range(n // 500):
        (work / f"stack_{k:04d}.mrcs").touch()
    metadata.dataframe2file(df, str(work / "in.star"))

    argv = ["in.star", "out_sub.star", *ETL_CHAIN, "--verbose", "0", "--force", "1"]
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "helicon_tpu_torch.commands.helicon",
                          "images2star", *argv], cwd=work, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    wall_sub = time.perf_counter() - t0
    if sub.returncode != 0:
        print(sub.stdout[-6000:], sub.stderr[-6000:], sep="\n", flush=True)
        raise AssertionError(f"phase 16 (a): images2star exited {sub.returncode}")

    runs = []
    for run in range(2):
        out = f"out_in{run}.star"
        parser = argparse.ArgumentParser()
        images2star.add_args(parser)
        run_argv = ["in.star", out, *ETL_CHAIN, "--verbose", "0", "--force", "1"]
        args = images2star.check_args(parser.parse_args(run_argv), parser, run_argv)
        parts = {}
        with _cwd(work), _timed_calls(metadata, ("images2dataframe", "dataframe2file"), parts), \
                _timed_calls(ops, ("dispatch",), parts):
            t0 = time.perf_counter()
            images2star.main(args)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = metadata.images2dataframe(out, ignore_bad_particle_path=2)
            parts["read back"] = time.perf_counter() - t0
        runs.append(dict(wall=wall, parts=parts, rows_out=len(back),
                         text=(work / out).read_bytes()))
    same = runs[0]["text"] == runs[1]["text"] == (work / "out_sub.star").read_bytes()
    r = runs[1]
    chain_s = r["parts"]["images2dataframe"] + r["parts"]["dispatch"] + r["parts"]["dataframe2file"]
    print(f"phase 16 (a) [images2star, bench.py's ETL chain on {n} rows: select 10 of 50 "
          f"classes, addParm, multParm, sortby, breakFilaments maxSegments=20, "
          f"removeDuplicates, write, read back]: subprocess start to exit {wall_sub:.3f} s; in "
          f"process {n / chain_s:.0f} rows/s (read {r['parts']['images2dataframe']:.3f} s, "
          f"plugins {r['parts']['dispatch']:.3f} s, write {r['parts']['dataframe2file']:.3f} s; "
          f"read back {r['parts']['read back']:.3f} s; main {r['wall']:.3f} s; first run "
          f"{n / (runs[0]['parts']['images2dataframe'] + runs[0]['parts']['dispatch'] + runs[0]['parts']['dataframe2file']):.0f} "
          f"rows/s), {r['rows_out']} rows out; the two in-process runs and the subprocess "
          f"wrote equal files: {same}; {card}", flush=True)
    if not same or not 0 < r["rows_out"] < n:
        raise AssertionError("phase 16 (a): the runs wrote different files or no rows")
    return dict(wall_sub=wall_sub, rows_per_s=n / chain_s, parts=r["parts"], rows_out=r["rows_out"])


def _particle_stacks(work: Path, device):
    """I2S["stacks"] stacks of I2S["per_stack"] particles of I2S["size"]^2:
    an amyloid projection from the port's simulator, shifted and scaled per
    particle, plus seeded numpy Gaussian noise."""
    import numpy as np

    from helicon_tpu_torch.helix import simulate_helical_projection
    from helicon_tpu_torch.io.mrc import write_mrc

    m, apix = I2S["size"], 1.0
    proj = np.ascontiguousarray(np.asarray(simulate_helical_projection(
        1, -1.2, 4.75, 1, min(100.0, 0.5 * m), 3.0, 0, 1.0, m, m, apix, rng=I2S["seed"],
        device=device)).T)
    proj /= proj.std()
    g = np.random.default_rng(I2S["seed"] + 1)
    names = []
    for k in range(I2S["stacks"]):
        shifts = g.integers(-20, 21, I2S["per_stack"])
        imgs = g.standard_normal((I2S["per_stack"], m, m), dtype=np.float32)
        for i, s in enumerate(shifts):
            imgs[i] += np.roll(proj, int(s), axis=1)
        write_mrc(work / f"particles_{k}.mrcs", imgs, apix=apix)
        names += [f"{i + 1:06d}@{work}/particles_{k}.mrcs" for i in range(I2S["per_stack"])]
    return names


def phase_i2s_create_stack(device, card) -> dict:
    """Phase 16 (b): see the module docstring."""
    import numpy as np
    import pandas as pd

    from helicon_tpu_torch.io.mrc import read_mrc

    work = PH16 / "stack"
    work.mkdir(parents=True, exist_ok=True)
    names = _particle_stacks(work, device)
    n, m, r = len(names), I2S["size"], I2S["rescale"]
    frame = pd.DataFrame({"rlnImageName": names, "rlnOpticsGroup": 1})
    frame.attrs["optics"] = pd.DataFrame({"rlnOpticsGroup": [1], "rlnImagePixelSize": [1.0],
                                          "rlnImageSize": [m]})
    _peak_gib(reset=True)
    out, wall = _sync_wall(lambda: _i2s("createStack", frame.copy(),
                                        f"{work}/out.mrcs:rescale2size={r}", device))
    peak = _peak_gib()
    stack, apix = read_mrc(work / "out.mrcs")
    rows = np.linspace(0, n - 1, I2S["held"]).astype(int)
    held = frame.iloc[rows].reset_index(drop=True)
    ref = {}
    for tag, dev in (("card", device), ("cpu", "cpu")):
        _i2s("createStack", held.copy(), f"{work}/held_{tag}.mrcs:rescale2size={r}:float16=0",
             dev)
        ref[tag] = read_mrc(work / f"held_{tag}.mrcs")[0]
    a, b = ref["card"].astype(np.float64), ref["cpu"].astype(np.float64)
    err = float(np.max(np.abs(a - b).max(axis=(1, 2)) / np.abs(b).max(axis=(1, 2))))
    # the float16 stack's rows: the float32 gate (the main run crops 256
    # images a call, the held run 16), then one float16 rounding step
    f16 = stack[rows].astype(np.float64)
    ulp = np.spacing(np.abs(a).astype(np.float16)).astype(np.float64)
    pk = np.abs(a).max(axis=(1, 2), keepdims=True)
    f16_ok = bool(np.all(np.abs(f16 - a) <= ulp + 1e-5 * pk))
    f16_err = float(np.max((np.abs(f16 - a) - ulp) / pk))
    print(f"phase 16 (b) [--createStack out.mrcs:rescale2size={r} (float16), {n} particles of "
          f"{m}^2 in {I2S['stacks']} stacks of {I2S['per_stack']}]: {wall:.3f} s, "
          f"{n / wall:.1f} images/s, peak device memory {peak:.3f} GiB; the stack "
          f"{stack.shape} {stack.dtype} at {apix:.4f} A/px, rows renamed "
          f"{out['rlnImageName'].iloc[-1].split('@')[0]}; {len(rows)} images with float16=0 on "
          f"the card against the CPU within {err:.3e} of each image's peak (limit 1e-5), the "
          f"float16 stack's rows within that plus one float16 ulp of them: {f16_ok} "
          f"({f16_err:.3e} of the peak beyond one ulp); {card}", flush=True)
    if (stack.shape != (n, r, r) or not np.all(np.isfinite(stack)) or not err <= 1e-5
            or not f16_ok or abs(apix - m / r) > 1e-4):
        raise AssertionError("phase 16 (b): the stack is off or differs from the CPU's")
    return dict(wall=wall, images_per_s=n / wall, peak=peak, err=err)


def _micrographs(work: Path):
    """I2S["mics"] micrographs of I2S["mic_size"]^2 at I2S["mic_apix"] A/px:
    seeded numpy Gaussian noise on a smooth ice gradient, with
    I2S["discs"] dark gold discs of radius I2S["disc_radius"] A each.
    Returns the paths and each micrograph's disc mask."""
    import numpy as np

    from helicon_tpu_torch.io.mrc import write_mrc

    n, apix = I2S["mic_size"], I2S["mic_apix"]
    g = np.random.default_rng(I2S["seed"] + 2)
    ramp = (np.linspace(-2.0, 2.0, n, dtype=np.float32)[:, None]
            + np.linspace(-1.0, 1.0, n, dtype=np.float32)[None, :])
    paths, masks = [], []
    for k in range(I2S["mics"]):
        img = g.standard_normal((n, n), dtype=np.float32) + ramp
        disc = np.zeros((n, n), bool)
        for cy, cx, rad in zip(g.uniform(100, n - 100, I2S["discs"]),
                               g.uniform(100, n - 100, I2S["discs"]),
                               g.uniform(*I2S["disc_radius"], I2S["discs"]) / apix):
            y0, y1 = int(cy - rad) - 1, int(cy + rad) + 2
            x0, x1 = int(cx - rad) - 1, int(cx + rad) + 2
            yy, xx = np.mgrid[y0:y1, x0:x1]
            disc[y0:y1, x0:x1] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
        img[disc] -= 12.0
        paths.append(work / f"mic_{k}.mrc")
        write_mrc(paths[-1], img, apix=apix)
        masks.append(disc)
    return paths, masks


def phase_i2s_mask_gold(device, card, mics) -> dict:
    """Phase 16 (c): see the module docstring."""
    import numpy as np
    import pandas as pd

    from helicon_tpu_torch.io.mrc import read_image_2d, read_mrc
    from helicon_tpu_torch.ops.images2star.heavy import gold_mask

    work = PH16 / "mics"
    paths, discs = mics
    frame = pd.DataFrame({"rlnMicrographName": [str(p) for p in paths]})
    _peak_gib(reset=True)
    with _cwd(work):
        out, wall = _sync_wall(lambda: _i2s("maskGold", frame.copy(), "outdir=masked", device))
    peak = _peak_gib()
    masked = read_mrc(work / "masked" / paths[0].name)[0].reshape(discs[0].shape)
    img = read_image_2d(paths[0], 0)
    # the option's automatic gradient_sigma: sqrt(min_area) * 10 = 100 A
    res = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        res[str(dev)] = gold_mask(img, I2S["mic_apix"], 4.0, 100.0, 100.0, 1, dev)
        res[f"{dev} s"] = time.perf_counter() - t0
    (fa, ma, meda, mada), (fb, mb, medb, madb) = res[str(device)], res["cpu"]
    thr = [medb + 4.0 * madb * 1.4826, medb - 4.0 * madb * 1.4826]
    differ = ma != mb
    near = np.zeros_like(differ)
    for t in thr:
        near |= np.abs(fb - t) <= 1e-5 * abs(t)
    found = float(mb[discs[0]].mean())
    same_out = bool(np.array_equal(np.isclose(masked, fa, rtol=0, atol=0), ~ma))
    print(f"phase 16 (c) [--maskGold on {len(paths)} micrographs of {I2S['mic_size']}^2 at "
          f"{I2S['mic_apix']} A/px with {I2S['discs']} planted gold discs each, gradient_sigma "
          f"automatic (100 A)]: {wall:.3f} s, {wall / len(paths):.3f} s per micrograph, peak "
          f"device memory {peak:.3f} GiB; micrograph 0 card against CPU: {int(differ.sum())} "
          f"mask pixels differ, all within 1e-5 of a threshold: {bool(np.all(near[differ]))}; "
          f"{ma.sum()} pixels masked, {found:.4f} of the discs' pixels; the option's output "
          f"is the card's decision: {same_out}; gold_mask card {res[f'{device} s']:.3f} s, "
          f"cpu {res['cpu s']:.3f} s; {card}", flush=True)
    if not np.all(near[differ]) or found < 0.5 or not same_out:
        raise AssertionError("phase 16 (c): the card's mask differs from the CPU's")
    return dict(wall=wall, per_mic=wall / len(paths), peak=peak, differ=int(differ.sum()))


def phase_i2s_denoise(device, card, mics) -> dict:
    """Phase 16 (d): see the module docstring."""
    import functools

    import numpy as np
    import pandas as pd

    from helicon_tpu_torch.core import curvelet
    from helicon_tpu_torch.io.mrc import read_mrc, write_mrc

    work = PH16 / "denoise"
    work.mkdir(parents=True, exist_ok=True)
    n, m = I2S["dn_particles"], I2S["size"]
    src = read_mrc(PH16 / "stack" / "particles_0.mrcs")[0][:n]
    write_mrc(work / "p.mrcs", src, apix=1.0)
    frame = pd.DataFrame({"rlnImageName": [f"{i + 1:06d}@{work}/p.mrcs" for i in range(n)]})
    _peak_gib(reset=True)
    _, wall = _sync_wall(lambda: _i2s("denoiseCurvelet", frame.copy(),
                                      f"transform=mct:outdir={work}/dn", device))
    peak = _peak_gib()
    den = read_mrc(work / "dn" / "p.mrcs")[0]
    # the held particles, card and CPU, through the option with the kept-mask hold
    k = I2S["dn_held"]
    held = frame.iloc[np.linspace(0, n - 1, k).astype(int)].reset_index(drop=True)
    U2, _ = curvelet.curvelet_bands_2d((m, m), device="cpu")
    hold, outs = _MaskHold(U2, (-2, -1)), {}
    real = curvelet.denoise_curvelet_2d
    for tag, dev, hook in (("card", device, hold.record), ("cpu", "cpu", hold.hold)):
        curvelet.denoise_curvelet_2d = functools.partial(real, on_band=hook)
        try:
            _i2s("denoiseCurvelet", held.copy(), f"transform=mct:outdir={work}/held_{tag}", dev)
        finally:
            curvelet.denoise_curvelet_2d = real
        outs[tag] = read_mrc(work / f"held_{tag}" / "p.mrcs")[0]
    ref = outs["cpu"].astype(np.float64)
    peaks = np.abs(ref).max(axis=(1, 2))
    err = float(np.max(np.abs(outs["card"] - hold.delta - ref).max(axis=(1, 2)) / peaks))
    rows = np.linspace(0, n - 1, k).astype(int)
    alone = float(np.max(np.abs(den[rows] - outs["card"]).max(axis=(1, 2)) / peaks))
    # the micrograph route: each unique micrograph once, through the batch
    # seam, which takes them to the card one at a time; one micrograph, then
    # I2S["dn_mics"] (links to (c)'s files): the peak must not grow with
    # the count (held together, each would add its upload, its result and a
    # stacked copy)
    n_mics = I2S["dn_mics"]
    links = [work / f"mic_{k}.mrc" for k in range(n_mics)]
    for i, link in enumerate(links):
        link.unlink(missing_ok=True)
        link.symlink_to(mics[0][i % len(mics[0])])
    walls, peaks, first = {}, {}, {}
    for count in (1, n_mics):
        mf = pd.DataFrame({"rlnMicrographName": [str(p) for p in links[:count]]})
        curvelet._windows_2d.cache_clear()
        _peak_gib(reset=True)
        _, walls[count] = _sync_wall(lambda: _i2s("denoiseCurvelet", mf,
                                                  f"outdir={work}/dn_mics_{count}", device))
        peaks[count] = _peak_gib()
        first[count] = read_mrc(work / f"dn_mics_{count}" / links[0].name)[0]
    curvelet._windows_2d.cache_clear()
    dmic = read_mrc(work / f"dn_mics_{n_mics}" / links[-1].name)[0]
    mic_gib = 4 * I2S["mic_size"] ** 2 / 2**30
    grow = peaks[n_mics] - peaks[1]
    wall_mic, peak_mic = walls[n_mics], peaks[n_mics]
    print(f"phase 16 (d) [--denoiseCurvelet transform=mct on {n} particles of {m}^2]: "
          f"{wall:.3f} s, {n / wall:.1f} images/s, peak device memory {peak:.3f} GiB; "
          f"{k} particles card against CPU: {hold.bands} bands held, {hold.flips} keep "
          f"decisions differ (each within {KEEP_REL} of its threshold), thresholds within "
          f"{hold.thr_err:.3e}, images within {err:.3e} of each CPU image's peak with the "
          f"differing decisions' synthesis taken out (limit 1e-4); the {n}-particle run's "
          f"rows against the held card run {alone:.3e}; micrograph route (mct defaults, "
          f"{I2S['mic_size']}^2): one {walls[1]:.3f} s, peak {peaks[1]:.3f} GiB; {n_mics} "
          f"{wall_mic:.3f} s, peak {peak_mic:.3f} GiB, {grow:+.3f} GiB over one (limit "
          f"{2 * mic_gib:.3f}: two micrographs; held together the {n_mics} would add "
          f"~{3 * (n_mics - 1) * mic_gib:.3f}); the first micrograph equal in both runs "
          f"{bool(np.array_equal(first[1], first[n_mics]))}, finite "
          f"{bool(np.all(np.isfinite(dmic)))}; {card}", flush=True)
    if (hold.first or hold.bands != 48 or not err <= 1e-4
            or not hold.thr_err <= KEEP_REL or den.shape != (n, m, m)
            or not np.all(np.isfinite(den)) or not np.all(np.isfinite(dmic))
            or not grow <= 2 * mic_gib or not np.array_equal(first[1], first[n_mics])):
        raise AssertionError("phase 16 (d): the card's denoising differs from the CPU's")
    return dict(wall=wall, images_per_s=n / wall, peak=peak, err=err, flips=hold.flips,
                wall_mic=wall_mic, peak_mic=peak_mic, peak_mic1=peaks[1])


def phase_i2s_extract(device, card, mics) -> dict:
    """Phase 16 (e): see the module docstring."""
    import numpy as np
    import pandas as pd

    from helicon_tpu_torch.io.mrc import read_mrc
    from helicon_tpu_torch.io.star import write_star

    work = PH16 / "mics"
    paths = mics[0]
    size = I2S["mic_size"]
    g = np.random.default_rng(I2S["seed"] + 3)
    rows = []
    for p in paths:
        c = np.empty((2 * I2S["filaments"], 2))
        for f in range(I2S["filaments"]):
            length = g.uniform(0.2, 0.6) * size
            ang = g.uniform(0, np.pi)
            d = length / 2 * np.array([np.cos(ang), np.sin(ang)])
            mid = g.uniform(0.1 * size + abs(d), 0.9 * size - abs(d))
            c[2 * f], c[2 * f + 1] = mid - d, mid + d
        star = work / f"{p.stem}_coords.star"
        write_star(star, pd.DataFrame({"rlnCoordinateX": c[:, 0], "rlnCoordinateY": c[:, 1]}))
        rows.append({"rlnMicrographName": str(p), "rlnCoordinateFileName": str(star)})
    frame = pd.DataFrame(rows)
    _peak_gib(reset=True)
    out, wall = _sync_wall(lambda: _i2s("extractHelices", frame.copy(),
                                        f"width={I2S['width']}:outPath={work}/helices", device))
    peak = _peak_gib()
    cpu = _i2s("extractHelices", frame.iloc[:1].copy(),
               f"width={I2S['width']}:outPath={work}/helices_cpu", "cpu")
    mine = out[out["rlnMicrographName"] == str(paths[0])].reset_index(drop=True)
    errs = []
    for i in range(I2S["strips_held"]):
        a = read_mrc(mine["rlnImageName"].iloc[i].split("@")[1])[0]
        b = read_mrc(cpu["rlnImageName"].iloc[i].split("@")[1])[0]
        errs.append(float(np.abs(a - b).max() / np.abs(b).max()) if a.shape == b.shape
                    else np.inf)
    n_strips = len(out)
    print(f"phase 16 (e) [--extractHelices width={I2S['width']}, {I2S['filaments']} filaments "
          f"on each of {len(paths)} micrographs of {size}^2]: {wall:.3f} s for {n_strips} "
          f"strips, peak device memory {peak:.3f} GiB; {len(errs)} strips of micrograph 0 "
          f"card against CPU within {max(errs):.3e} of the strip's peak (limit 1e-5); {card}",
          flush=True)
    if n_strips != I2S["filaments"] * len(paths) or not max(errs) <= 1e-5:
        raise AssertionError("phase 16 (e): strips missing or off the CPU's")
    return dict(wall=wall, strips=n_strips, peak=peak, err=max(errs))


def phase_i2s_calibrate(device, card) -> dict:
    """Phase 16 (f): see the module docstring."""
    import numpy as np
    import pandas as pd

    from helicon_tpu_torch.io.mrc import write_mrc

    work = PH16 / "calibrate"
    work.mkdir(parents=True, exist_ok=True)
    n, size, radius = I2S["cal_n"], I2S["cal_size"], I2S["cal_radius"]
    apix_true = 2.355 * radius / size  # the gold ring on an integer radius
    nominal = round(apix_true * I2S["cal_off"], 4)
    g = np.random.default_rng(I2S["seed"] + 4)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    ring = sum(np.cos(np.float32(2 * np.pi * radius / size) * (x * np.cos(t) + y * np.sin(t)))
               for t in np.linspace(0, np.pi, 8, endpoint=False)).astype(np.float32)
    imgs = g.standard_normal((n, size, size), dtype=np.float32) * 4.0 + ring
    write_mrc(work / "ring.mrcs", imgs, apix=nominal)
    frame = pd.DataFrame({"rlnImageName": [f"{i + 1:06d}@{work}/ring.mrcs" for i in range(n)],
                          "rlnImagePixelSize": nominal, "rlnDefocusU": 15000.0,
                          "rlnDefocusV": 14000.0})
    _peak_gib(reset=True)
    out, wall = _sync_wall(lambda: _i2s("calibratePixelSize", frame.copy(), "gold", device))
    peak = _peak_gib()
    t0 = time.perf_counter()
    cpu = _i2s("calibratePixelSize", frame.copy(), "gold", "cpu")
    wall_cpu = time.perf_counter() - t0
    got, want = float(out["rlnImagePixelSize"].iloc[0]), float(cpu["rlnImagePixelSize"].iloc[0])
    rel = abs(got - apix_true) / apix_true
    print(f"phase 16 (f) [--calibratePixelSize gold on {n} images of {size}^2, a ring at 2.355 "
          f"A planted at apix {apix_true:.5f}, the header {nominal} (2 % off)]: {wall:.3f} s "
          f"on the card ({wall_cpu:.3f} s on the CPU), peak device memory {peak:.3f} GiB; "
          f"apix_new {got} (CPU {want}), {rel:.2e} from the truth (limit 1e-3); {card}",
          flush=True)
    if got != want or not rel <= 1e-3:
        raise AssertionError("phase 16 (f): apix_new differs from the CPU's or the truth")
    return dict(wall=wall, wall_cpu=wall_cpu, apix_new=got, rel=rel, peak=peak)


def phase_images2star(device, card) -> dict:
    """Phase 16 (a)-(f)."""
    import shutil

    shutil.rmtree(PH16, ignore_errors=True)
    (PH16 / "mics").mkdir(parents=True)
    out = {}
    t0 = time.perf_counter()
    mics = _micrographs(PH16 / "mics")
    out["data"] = {"phase_s": time.perf_counter() - t0}
    for key, fn, extra in (("a", phase_i2s_etl, ()), ("b", phase_i2s_create_stack, ()),
                           ("c", phase_i2s_mask_gold, (mics,)),
                           ("d", phase_i2s_denoise, (mics,)),
                           ("e", phase_i2s_extract, (mics,)), ("f", phase_i2s_calibrate, ())):
        t0 = time.perf_counter()
        out[key] = fn(device, card, *extra)
        out[key]["phase_s"] = time.perf_counter() - t0
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
    print(f"host packages: {_host_packages()}", flush=True)
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
    incremental = phase_incremental(device, nn_scores)
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
    cli_runs = phase_cli(device, card)
    wide = phase_cli_two_processes(device, card)
    t12 = time.perf_counter()
    webapp = phase_webapp_task(device, card)
    webapp_grid = phase_webapp_grid(device, incremental["scores"])
    phase_webapp_simulate(device, webapp["tilt 0"])
    webapp_fsc = phase_webapp_grouped_fsc(device)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s", flush=True)
    t13 = time.perf_counter()
    phase_truefsc(device, card)
    phase_proc3d(device, card)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    t14 = time.perf_counter()
    phase_curvelet(device, card)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
    t15 = time.perf_counter()
    arrays = phase_helical_arrays(device, card)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s (by part "
          f"{json.dumps({k: round(v['phase_s'], 1) for k, v in arrays.items()})})", flush=True)
    t16 = time.perf_counter()
    i2s = phase_images2star(device, card)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s (by part "
          f"{json.dumps({k: round(v['phase_s'], 1) for k, v in i2s.items()})})", flush=True)
    webapp_launches = {k: sum(d["launches"][k] for d in (*webapp.values(), webapp_grid))
                       + sum(d["launches_app"][k] for d in webapp.values()) for k in _counts()}
    webapp_launches["group_solve"] += webapp_fsc["launches"]

    def entry(name, src, replaces, launches, r, **extra):
        return dict(name=name, route="cuda", source=CSRC + src, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"), device_ms=r.get("device_ms"),
                    host_ms=r.get("host_ms"), launches_webapp=webapp_launches[name],
                    **extra)

    def other(n, interp):
        """A gather kernel's launches on phase 9 (b)'s and 10 (d)'s paths and
        on phase 11 (b)'s CLI run, and its linear row of phase 10 (a)."""
        extra = dict(launches_tilt3=tilted["gather_launches"][n],
                     launches_refine_all=refine_all["launches"][n],
                     launches_cli=cli_runs["b"]["launches"][n])
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
                                            "bound_by", "groups", "products")},
              bucketed=dict(launches_first=bucketed["sums"]["first"]["launches"],
                            launches_second=bucketed["sums"]["second"]["launches"],
                            launches_winner=bucketed["sums"]["winner"]["launches"]),
              # phase 11 (a): the CLI's run of phase 4's grid; (d): the
              # first float32 launch of the wide-rise search against plain
              launches_cli=cli_runs["a"]["launches"]["group_solve"],
              cli_wide_float32=wide["held"]["B1"]),
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
                                                       "plain_ms", "bound_ms", "bound_by",
                                                       "products")},
                  # ard's and elasticnet + fsc 2's golden searches, B2
                  # against plain (score errors), one of each search's
                  # launches timed, and phase 5's float32 k = 8 checks
                  matvec=dict(score_abs_err=ard["max_abs_err"],
                              float32_score_abs_err=ard["float32_err"],
                              search=ard["search_matvec"], k8=ard["k8"]),
                  gz_j=dict(score_abs_err=fsc_reg["max_abs_err"],
                            float32_score_abs_err=fsc_reg["float32_err"],
                            search=fsc_reg["search_half"], k8=fsc_reg["k8"]),
                  gather_projector=dict(P_ms=tilted["P_ms"], PT_ms=tilted["PT_ms"])),
              # phase 11 (a): the CLI's best-volume re-solve; (d): the
              # first float32 launch of the wide-rise search against plain
              launches_cli=cli_runs["a"]["launches"]["solve_candidate"],
              cli_wide_float32=wide["held"]["B2"]),
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
        # PT(rows * P(x)) in one call: K1 and K2 on the list (the jax.vjp of
        # P after P, the solver's data term)
        entry("gather_normal", "gather_projector.cu", "helicon_tpu/denovo3d/projector.py:153",
              cli["launches"]["gather_normal"], gather[("normal", "nn")],
              **other("gather_normal", gather[("normal", "linear")])),
        # each listed ray's samples, once a pose (P's sampling, tabulated)
        entry("sample_table", "gather_projector.cu", "helicon_tpu/denovo3d/projector.py:153",
              cli["launches"]["sample_table"], gather[("table", "nn")],
              **other("sample_table", None)),
        entry("pose_jacobian", "gather_projector.cu", "helicon_tpu/denovo3d/refine.py:50",
              cli["launches"]["pose_jacobian"], gather[("jacobian", "linear")],
              **other("pose_jacobian", None)),
        # K4's item list and its incidences, once a pose (S's sampling,
        # tabulated)
        entry("sym_items", "gather_projector.cu", "helicon_tpu/denovo3d/projector.py:230",
              cli["launches"]["sym_items"], gather[("sym_items", "nn")],
              **other("sym_items", gather[("sym_items", "linear")])),
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
