"""De novo helical indexing + 3D reconstruction from a 2D image (batch CLI)

The port's counterpart of ``helicon_tpu/commands/denovo3d_cli.py``:
scores a (twist, rise) candidate grid for one class average on the card
and writes a ranked table, a summary and the best reconstruction.

Example:
  python -m helicon_tpu_torch.commands.denovo3d_cli classes.mrcs output \\
      --imageIndex 1 --apix 2.96 --twist 0.5 45 0.5 --rise 4.0 5.0 0.25

Several processes (one per card, or several on one card) split the grid
when started by torchrun:
  torchrun --nproc_per_node 2 -m helicon_tpu_torch.commands.denovo3d_cli ...
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def main(args: argparse.Namespace) -> None:
    from ..io.mrc import read_image_2d
    from ..parallel import multihost
    from ..utils.logging import log_command_line

    log_command_line()
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR,
        format="%(message)s",
        stream=sys.stdout,
    )
    # several processes: a launcher (torchrun) sets RANK / WORLD_SIZE /
    # MASTER_ADDR / MASTER_PORT and runs this same command in each; the grid
    # is split across them and every process ends with the full ranking
    # (parallel/multihost.py). One process is untouched. --checkpoint then
    # keeps one shard per process (<prefix>.ckpt.p<rank>.npz).
    multihost.initialize()

    apix, indices, twists, rises, refine_range = search_plan(args)
    logger.info(
        "%d (twist, rise) candidates x %d image(s) of %s (apix %.3f A)",
        len(twists), len(indices), args.input_image, apix,
    )
    all_summaries = []
    for image_index in indices:
        img = read_image_2d(args.input_image, image_index - 1)
        _, summary = _search_one(
            args, img, apix, twists, rises, refine_range, image_index,
            multi=len(indices) > 1,
        )
        all_summaries.append(summary)
    if len(indices) > 1 and multihost.is_writer():
        # string concat, not with_suffix: a prefix like "run.v2" keeps ".v2"
        batch = Path(str(args.output_prefix) + ".batch.json")
        batch.write_text(json.dumps(all_summaries, indent=1))
        logger.info("batch summary -> %s", batch)
    multihost.shutdown()


def search_plan(args):
    """(apix, the 1-based image indices, twists, rises, the refinement
    bounds or None) of a command line, as main searches them."""
    from ..denovo3d import build_candidate_grid
    from ..io.mrc import mrc_header

    header = mrc_header(args.input_image)
    apix = args.apix if args.apix > 0 else header.apix
    indices = list(args.imageIndex)
    if indices == [0]:  # 0 = every image in the stack (batch mode)
        indices = list(range(1, int(header.nz) + 1))
    elif any(i < 1 for i in indices):
        raise SystemExit(
            "--imageIndex values are 1-based (a SINGLE 0 selects every "
            f"image); got {indices}"
        )
    twists, rises = build_candidate_grid(
        args.twist[0], args.twist[1], args.twist[2],
        args.rise[0], args.rise[1], args.rise[2],
        handedness=args.handedness,
    )
    # the refinement bounds: an axis of 0 is not refined; none -> no refinement
    refine_range = None
    if args.refineTiltPsiDy is not None:
        t_rng, p_rng, d_rng = args.refineTiltPsiDy
        r_dict = {}
        if t_rng > 0:
            r_dict["tilt"] = t_rng
        if p_rng > 0:
            r_dict["psi"] = p_rng
        if d_rng > 0:
            r_dict["dy"] = d_rng
        refine_range = r_dict or None
    return apix, indices, twists, rises, refine_range


def search_kwargs(args, apix, twists, rises, refine_range) -> dict:
    """The keyword arguments the CLI passes to the search (besides the
    image and the checkpoint's)."""
    return dict(
        apix=apix,
        twists=twists,
        rises=rises,
        csym=args.csym,
        low_pass=args.lowPass,
        transpose=args.transpose,
        horizontalize=args.horizontalize,
        target_apix2d=args.targetApix2d,
        target_apix3d=args.targetApix3d,
        tube_diameter=args.tubeDiameter,
        reconstruct_length_rise=args.reconstructLengthRise,
        thresh_fraction=args.threshFraction,
        positive_constraint=args.positiveConstraint,
        sym_oversample=args.symOversample,
        interpolation=args.interpolation,
        score_metric=args.scoreMetric,
        fsc_test=args.fscTest,
        refine_tilt_psi_dy_range=refine_range,
        refine_top_k=args.refineTopK,
        refine_mode=args.refineMode,
        cg_iters=args.cgIters,
        fista_iters=args.fistaIters,
        compute_dtype=args.computeDtype,
        batch_size=args.batchSize if args.batchSize > 0 else None,
        return_best_volume=True,
        densify_padding=bool(args.densifyPadding),
        device=args.device,
    )


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count so far in this process."""
    from ..denovo3d import candidate_solve, gather_kernels, group_solve

    return dict(group_solve=group_solve.launches, **candidate_solve.launches,
                **gather_kernels.launches)


def _search_one(args, img, apix, twists, rises, refine_range, image_index, multi=False):
    from ..denovo3d import reconstruct_grid, reconstruct_grid_checkpointed
    from ..io.mrc import write_mrc
    from ..parallel import multihost
    from ..utils.logging import Timer

    search = reconstruct_grid
    ckpt_kw = {}
    if args.checkpoint:
        # a per-image checkpoint next to the outputs: a killed run resumes
        # from the last completed chunk on the same command line
        p = Path(args.output_prefix)
        if multi:
            p = p.parent / f"{p.name}_{image_index:03d}"
        if multihost.is_distributed():
            # per-process shards under the same base name
            search = multihost.multihost_reconstruct_grid
            ckpt_kw = dict(checkpoint_path=str(p) + ".ckpt.npz",
                           checkpoint_chunk=int(args.checkpoint))
        else:
            search = reconstruct_grid_checkpointed
            ckpt_kw = dict(checkpoint_path=str(p) + ".ckpt.npz", chunk=int(args.checkpoint))
    elif multihost.is_distributed():
        search = multihost.multihost_reconstruct_grid

    before = _launch_counts()
    with Timer(f"grid search (image {image_index})", verbose=args.verbose) as timer:
        res = search(img, **ckpt_kw, **search_kwargs(args, apix, twists, rises, refine_range))

    if args.verbose and res.effective:
        eff = res.effective
        logger.info("scoring path: %s (R=%s, n_groups=%s)", eff.get("path", "?"),
                    eff.get("R", "-"), eff.get("n_groups", "-"))
        # the whole dispatch, the search's wall, every kernel's launches in
        # this search, the refined poses and the card's peak memory, on one
        # line a script reads
        after = _launch_counts()
        extra = dict(wall_s=timer.elapsed, launches={k: after[k] - before[k] for k in after})
        if res.refined_params:
            extra["refined"] = {int(k): list(map(float, v)) for k, v in res.refined_params.items()}
        dev = multihost.local_device(args.device)
        if dev.type == "cuda":
            import torch

            extra["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        logger.info("effective: %s", json.dumps(
            dict(eff, **extra), default=lambda o: o.item() if hasattr(o, "item") else str(o)))

    # several processes: every one holds the full ranking; rank 0 writes
    # the table and summary files, the process that re-solved the winner
    # its volume
    writer = multihost.is_writer()
    top = res.top(args.topN)
    out_prefix = Path(args.output_prefix)
    if multi:  # per-image outputs in batch mode
        out_prefix = out_prefix.parent / f"{out_prefix.name}_{image_index:03d}"
    if writer:
        table = Path(str(out_prefix) + ".csv")
        with open(table, "w") as f:
            f.write("twist_degree,rise_angstrom,score\n")
            for i in np.argsort(-res.scores):
                f.write(f"{res.twists[i]:.4f},{res.rises[i]:.4f},{res.scores[i]:.6f}\n")
        logger.info("ranked candidates -> %s", table)
        if res.extras:
            ex = res.extras
            extras_csv = Path(str(out_prefix) + ".extras.csv")
            with open(extras_csv, "w") as f:
                f.write("twist_degree,rise_angstrom,score\n")
                for i in np.argsort(-ex["scores"]):
                    f.write(f"{ex['twists'][i]:.4f},{ex['rises'][i]:.4f},"
                            f"{ex['scores'][i]:.6f}\n")
            logger.info("%d densified extras -> %s", len(ex["scores"]), extras_csv)
        print("top candidates (twist deg, rise A, score):")
        for t, r, s in top:
            print(f"  {t:10.3f} {r:8.3f} {s:10.6f}")
    if res.best_volume is not None:
        vol_file = Path(str(out_prefix) + ".best.mrc")
        write_mrc(vol_file, res.best_volume, apix=res.target_apix3d)
        logger.info("best reconstruction -> %s", vol_file)
    if res.best_index < 0:
        # a partial result (an interrupted checkpointed run): best_index -1
        # is no candidate
        summary = dict(
            image_index=int(image_index),
            aborted=True,
            n_scored=int(np.count_nonzero(np.isfinite(res.scores))),
            n_candidates=int(len(twists)),
        )
        logger.warning("partial result (no winner): %d/%d candidates scored",
                       summary["n_scored"], summary["n_candidates"])
        if writer:
            Path(str(out_prefix) + ".json").write_text(json.dumps(summary, indent=1))
            print(json.dumps(summary))
        return res, summary
    summary = dict(
        image_index=int(image_index),
        best_twist=float(res.twists[res.best_index]),
        best_rise=float(res.rises[res.best_index]),
        best_score=float(res.scores[res.best_index]),
        n_candidates=int(len(twists)),
    )
    if res.refined_params and res.best_index in res.refined_params:
        t_r, p_r, d_r = res.refined_params[res.best_index]
        summary.update(refined_tilt=float(t_r), refined_psi=float(p_r),
                       refined_dy_pixel=float(d_r))
    if writer:
        Path(str(out_prefix) + ".json").write_text(json.dumps(summary, indent=1))
        print(json.dumps(summary))
    return res, summary


def add_args(parser: argparse.ArgumentParser):
    parser.add_argument("input_image", help="2D class average (.mrc/.mrcs)")
    parser.add_argument("output_prefix", help="output file prefix")
    parser.add_argument("--imageIndex", type=int, nargs="+", default=[1],
                        help="1-based image index(es) in the stack; a "
                             "single 0 = every image (batch mode)")
    parser.add_argument("--apix", type=float, default=0,
                        help="pixel size (A); 0 = from the MRC header")
    parser.add_argument("--twist", type=float, nargs=3, default=[0.5, 45.0, 0.5],
                        metavar=("MIN", "MAX", "STEP"), help="twist grid (deg)")
    parser.add_argument("--rise", type=float, nargs=3, default=[4.0, 5.0, 0.25],
                        metavar=("MIN", "MAX", "STEP"), help="rise grid (A)")
    parser.add_argument("--csym", type=int, default=1, help="cyclic symmetry")
    parser.add_argument("--handedness", type=str, default="both",
                        choices=["both", "left", "right"])
    parser.add_argument("--lowPass", type=float, default=-1,
                        help="low-pass resolution (A)")
    parser.add_argument("--transpose", type=int, default=-1,
                        help="-1 auto, 0 no, 1 yes")
    parser.add_argument("--horizontalize", type=int, default=1)
    parser.add_argument("--targetApix2d", type=float, default=-1)
    parser.add_argument("--targetApix3d", type=float, default=-1)
    parser.add_argument("--tubeDiameter", type=float, default=-1)
    parser.add_argument("--reconstructLengthRise", type=float, default=3.0)
    parser.add_argument("--threshFraction", type=float, default=-1)
    parser.add_argument("--positiveConstraint", type=int, default=-1)
    parser.add_argument("--symOversample", type=int, default=-1)
    parser.add_argument("--interpolation", type=str, default="nn",
                        choices=["nn", "linear"])
    parser.add_argument("--scoreMetric", type=str, default="cosine",
                        choices=["cosine", "ssim", "ms_ssim",
                                 "mutual_information", "composite"])
    parser.add_argument("--fscTest", type=int, default=0,
                        help="half-set split mode 0-4 (0 = off)")
    parser.add_argument("--refineTiltPsiDy", type=float, nargs=3,
                        default=None, metavar=("TILT", "PSI", "DY"),
                        help="Gauss-Newton pose refinement bounds "
                             "(deg, deg, pixel); 0 disables an axis")
    parser.add_argument("--refineTopK", type=int, default=1,
                        help="refine this many top candidates")
    parser.add_argument("--refineMode", type=str, default="topk",
                        choices=["topk", "all"],
                        help="topk = score the fixed-pose grid, refine the "
                             "winners; all = refine every candidate inside "
                             "the grid")
    parser.add_argument("--cgIters", type=int, default=100)
    parser.add_argument("--fistaIters", type=int, default=40)
    parser.add_argument("--computeDtype", type=str, default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="auto = bfloat16 group operators on the card, "
                             "float32 on the CPU")
    parser.add_argument("--batchSize", type=int, default=0)
    parser.add_argument("--densifyPadding", type=int, default=0,
                        help="1 = fill the grouped solve's padding slots "
                             "with real interpolated rises (extras land in "
                             "<prefix>.extras.csv)")
    parser.add_argument("--checkpoint", type=int, default=0,
                        help="checkpoint the search every N candidates to "
                        "<prefix>.ckpt.npz; re-running the same command "
                        "resumes from the last completed chunk (0 = off)")
    parser.add_argument("--topN", type=int, default=10)
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the search (cuda = the card; "
                             "cpu runs the kernels' plain versions)")
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
