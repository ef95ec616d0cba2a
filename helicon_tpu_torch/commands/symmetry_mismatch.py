"""Relate two refinements of the same structure with different Cn symmetries

Finds the relative rotation between two CryoSPARC refinements with
different cyclic symmetries (e.g. C5 vs C12), unfolds each particle's
symmetry choice (k1, k2), and writes the aligned poses back.

Counterpart of ``helicon_tpu/commands/symmetry_mismatch.py``. The
consensus search of ``solve_symmetry_mismatch`` (:54) runs on ``--device``
(the card by default): the (n, sym1 sym2) float64 candidate table, every
seed's error in batched passes of seeds, the refinement and the final
assignment. The seeds are drawn on the host with the reference's
``np.random.choice`` on numpy's global generator, and the reference's
sequential 1e-9 tie rule picks among the seeds' errors on the host. The
particle matching (scipy KDTree / Rotation), the pose converters and the
CS IO are host code, copied. Local .cs-file mode only: the CryoSPARC
server's job mode needs cryosparc-tools. tests/test_torch_hom_symmismatch.py
pins the port to the original.

  helicon-torch symmetry_mismatch -i1 a.cs -s1 C5 -i2 b.cs -s2 C12 -of2 out.cs --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.spatial import KDTree
from scipy.spatial.transform import Rotation as R

from ..utils.exceptions import HeliconError

logger = logging.getLogger(__name__)

# bytes of float64 (seeds, particles, candidates) work one pass may hold on
# the CPU; on the card, half of its free memory up to SEED_CHUNK_BYTES_CUDA
SEED_CHUNK_BYTES_CPU = 1 << 28
SEED_CHUNK_BYTES_CUDA = 1 << 32


def convert_cryosparc_pose_to_scipy_Rotation(poses):
    """(N, 3) rotvec array -> scipy Rotation."""
    poses = np.asarray(poses)
    if poses.ndim == 3:
        poses = np.squeeze(poses)
    assert poses.ndim == 2 and poses.shape[1] == 3
    return R.from_rotvec(poses)


def convert_euler_angles_to_cryosparc_pose(eulers, convention: str = "ZXZ"):
    """Euler degrees -> rotvec poses."""
    return R.from_euler(seq=convention, angles=eulers, degrees=True).as_rotvec()


def angular_distance(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def _angular_distance_t(a: torch.Tensor, b) -> torch.Tensor:
    # torch.remainder is the floor modulo of numpy's %
    return torch.abs(torch.remainder(a - b + 180.0, 360.0) - 180.0)


def relative_angle_range(sym1: int, sym2: int) -> float:
    """360 * gcd / (sym1 * sym2)."""
    return 360.0 * np.gcd(sym1, sym2) / (sym1 * sym2)


def _seed_chunk(n: int, k: int, device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        budget = min(torch.cuda.mem_get_info(device)[0] // 2, SEED_CHUNK_BYTES_CUDA)
    else:
        budget = SEED_CHUNK_BYTES_CPU
    return max(1, budget // (n * k * 8 * 3))


def seed_errors(cands_flat: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Every seed angle's error: the sum over particles of the least
    angular distance between the seed and the particle's candidates,
    float64, in passes of seeds that fit the device."""
    n, k = cands_flat.shape
    step = _seed_chunk(n, k, cands_flat.device)
    out = []
    for s in range(0, len(seeds), step):
        d = _angular_distance_t(cands_flat[None], seeds[s: s + step, None, None])
        out.append(d.amin(dim=2).sum(dim=1))
    return torch.cat(out)


def solve_symmetry_mismatch(rot1, rot2, sym1, sym2, num_seed_samples=10, verbose=0,
                            device="cuda", return_seeds=False):
    """Consensus relative angle + per-particle symmetry unfolding on
    ``device``: candidate generation over the k1 x k2 unfoldings, the
    seeded consensus, refinement, final assignment. Returns
    (relative_angle, rot1_unfolded, rot2_unfolded); with ``return_seeds``
    also (seed angles, their errors, index of the chosen seed)."""
    period1 = 360.0 / sym1
    period2 = 360.0 / sym2
    max_angle = relative_angle_range(sym1, sym2)
    n = len(rot1)
    r1 = torch.as_tensor(np.asarray(rot1, float), device=device).reshape(n, 1, 1)
    r2 = torch.as_tensor(np.asarray(rot2, float), device=device).reshape(n, 1, 1)
    k1 = torch.arange(sym1, device=device, dtype=torch.float64).reshape(1, sym1, 1)
    k2 = torch.arange(sym2, device=device, dtype=torch.float64).reshape(1, 1, sym2)
    cands = torch.fmod((r2 + k2 * period2) - (r1 + k1 * period1) + 360.0, 360.0)
    cands_flat = cands.reshape(n, -1)

    num_seed_samples = min(num_seed_samples, n)
    pick = np.random.choice(n, num_seed_samples, replace=False)
    seeds_t = cands_flat[torch.as_tensor(pick, device=device)].flatten()
    errs = seed_errors(cands_flat, seeds_t).cpu().numpy()
    seeds = seeds_t.cpu().numpy()
    best, min_err = None, np.inf
    for s, (cand, err) in enumerate(zip(seeds, errs)):
        if err < min_err - 1e-9:
            min_err, best = err, s
        elif abs(err - min_err) <= 1e-9 and (best is None or cand < seeds[best]):
            best = s
    best_angle = seeds[best]

    diffs = _angular_distance_t(cands_flat, best_angle)
    best_idx = torch.argmin(diffs, dim=1)
    best_matches = cands_flat[torch.arange(n, device=device), best_idx]
    diff_vals = torch.remainder(best_matches - best_angle + 180.0, 360.0) - 180.0
    est = np.fmod(float(torch.mean(best_angle + diff_vals)) + 360.0, 360.0)
    est = np.fmod(est, max_angle)

    final_idx = torch.argmin(_angular_distance_t(cands_flat, float(est)), dim=1)
    ck1, ck2 = (final_idx // sym2).cpu().numpy(), (final_idx % sym2).cpu().numpy()
    rot1_unfolded = np.fmod(np.asarray(rot1) + ck1 * period1, 360.0)
    rot2_unfolded = np.fmod(np.asarray(rot2) + ck2 * period2, 360.0)
    if return_seeds:
        return est, rot1_unfolded, rot2_unfolded, (seeds, errs, best)
    return est, rot1_unfolded, rot2_unfolded


def find_particle_correspondence(ds1, ds2, dist_tol=None, axis_tol=None, verbose=0):
    """Match particles by UID or by micrograph + KDTree proximity, with
    optional relative-rotation-axis ~ +Z filtering. ds1/ds2:
    column-indexable mappings with numpy arrays. Returns (N, 2) matched
    uid pairs."""
    common_uids, idx1c, idx2c = np.intersect1d(
        ds1["uid"], ds2["uid"], return_indices=True
    )
    cand = {}
    if len(common_uids) > 0:
        for i1, i2 in zip(idx1c, idx2c):
            cand[i2] = [i1]
    else:
        if dist_tol is None:
            raise ValueError("dist_tol required when particles do not share UIDs")
        mics = np.intersect1d(
            np.unique(ds1["location/micrograph_uid"]),
            np.unique(ds2["location/micrograph_uid"]),
        )
        for mic in mics:
            idx1 = np.where(ds1["location/micrograph_uid"] == mic)[0]
            idx2 = np.where(ds2["location/micrograph_uid"] == mic)[0]
            if len(idx1) == 0 or len(idx2) == 0:
                continue
            pts1 = np.stack(
                [ds1["location/center_x_frac"][idx1], ds1["location/center_y_frac"][idx1]],
                axis=1,
            )
            pts2 = np.stack(
                [ds2["location/center_x_frac"][idx2], ds2["location/center_y_frac"][idx2]],
                axis=1,
            )
            if "location/micrograph_psize_A" in ds1 and "location/micrograph_shape" in ds1:
                psize = ds1["location/micrograph_psize_A"][idx1[0]]
                shape = np.asarray(ds1["location/micrograph_shape"][idx1[0]])
                scale = np.array([shape[1] * psize, shape[0] * psize])
                pts1 = pts1 * scale
                pts2 = pts2 * scale
            tree = KDTree(pts1)
            for i2_local, neighbors in enumerate(
                tree.query_ball_point(pts2, dist_tol)
            ):
                if neighbors:
                    cand[idx2[i2_local]] = [idx1[nb] for nb in neighbors]
    if not cand:
        return np.array([])

    def get_rotations(ds, indices):
        for field in ("alignments3D_multi/pose", "alignments3D/pose"):
            if field in ds:
                poses = np.asarray([ds[field][i] for i in indices])
                return convert_cryosparc_pose_to_scipy_Rotation(poses)
        return None

    matches = []
    if axis_tol is None or axis_tol <= 0:
        for i2, neighbors in cand.items():
            matches.append((ds1["uid"][neighbors[0]], ds2["uid"][i2]))
    else:
        vz_min = np.cos(np.deg2rad(axis_tol))
        all1 = sorted({i1 for v in cand.values() for i1 in v})
        all2 = sorted(cand.keys())
        rots1 = get_rotations(ds1, all1)
        rots2 = get_rotations(ds2, all2)
        if rots1 is None or rots2 is None:
            raise HeliconError(
                "no alignments3D/pose (or alignments3D_multi/pose) column "
                "in the inputs — the axis-tolerance test needs particle "
                "poses; rerun with --axis-tol 0 to match by position only"
            )
        R1 = dict(zip(all1, rots1))
        R2 = dict(zip(all2, rots2))
        for i2, neighbors in cand.items():
            rot2 = R2[i2]
            best, best_vz = None, vz_min
            for i1 in neighbors:
                rotvec = (rot2 * R1[i1].inv()).as_rotvec()
                angle = np.linalg.norm(rotvec)
                vz = 1.0 if angle < 1e-6 else abs(rotvec[2] / angle)
                if vz >= best_vz:
                    best, best_vz = i1, vz
            if best is not None:
                matches.append((ds1["uid"][best], ds2["uid"][i2]))
    return np.asarray(matches)


# ---------------------------------------------------------------- CLI


def _load(csFile, pass_through=None):
    import pandas as pd

    from ..io.cs import find_passthrough_file, read_cs

    cs = read_cs(csFile)
    df = pd.DataFrame.from_records(cs.tolist(), columns=cs.dtype.names)
    if pass_through:
        pt = Path(pass_through)
        if not pt.exists():
            raise HeliconError(
                f"passthrough file {pass_through} does not exist "
                "(-pt1/-pt2) — refusing to silently continue without it"
            )
    else:
        pt, warn = find_passthrough_file(csFile, prefer=("particles",))
        if pt is not None and warn:
            logger.warning(
                "using passthrough %s for %s — pass -pt1/-pt2 to override",
                pt, csFile,
            )
    if pt is not None:
        p = read_cs(pt)
        pdf = pd.DataFrame.from_records(p.tolist(), columns=p.dtype.names)
        add = [c for c in pdf.columns if c not in df.columns or c == "uid"]
        df = df.merge(pdf[add], on="uid", how="left")
    return df


def main(args):
    from ..io.metadata import dataframe2cs
    from ..utils.logging import log_command_line
    from . import command_device

    log_command_line()
    device = command_device(getattr(args, "device", "cuda"))
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR,
        format="%(message)s", stream=sys.stdout,
    )
    if not (args.input1 and args.input2):
        raise HeliconError(
            "provide --input1/--input2 (CryoSPARC server job mode "
            "requires cryosparc-tools)"
        )
    sym1 = int(str(args.sym1 or "C1").lstrip("Cc"))
    sym2 = int(str(args.sym2 or "C1").lstrip("Cc"))
    ds1 = _load(args.input1, pass_through=args.pass_through1)
    ds2 = _load(args.input2, pass_through=args.pass_through2)
    logger.info("job1: %d particles (C%d); job2: %d particles (C%d)",
                len(ds1), sym1, len(ds2), sym2)

    d1 = {c: ds1[c].values for c in ds1.columns}
    d2 = {c: ds2[c].values for c in ds2.columns}
    matches = find_particle_correspondence(
        d1, d2, dist_tol=args.dist_tol, axis_tol=args.axis_tol,
        verbose=args.verbose,
    )
    if len(matches) == 0:
        raise HeliconError("no matching particles between the two jobs")
    logger.info("%d matched particle pairs", len(matches))

    uid2i1 = {u: i for i, u in enumerate(d1["uid"])}
    uid2i2 = {u: i for i, u in enumerate(d2["uid"])}
    i1 = np.array([uid2i1[u] for u in matches[:, 0]])
    i2 = np.array([uid2i2[u] for u in matches[:, 1]])

    pose_col = next(
        (c for c in ("alignments3D/pose", "alignments3D_multi/pose") if c in ds1),
        None,
    )
    if pose_col is None:
        raise HeliconError("no alignments3D/pose column in the inputs")
    R1 = convert_cryosparc_pose_to_scipy_Rotation(np.stack(d1[pose_col][i1]))
    R2 = convert_cryosparc_pose_to_scipy_Rotation(np.stack(d2[pose_col][i2]))
    e1 = R1.as_euler("ZXZ", degrees=True)
    e2 = R2.as_euler("ZXZ", degrees=True)
    rel_angle, rot1_unf, rot2_unf = solve_symmetry_mismatch(
        e1[:, 0] % 360.0, e2[:, 0] % 360.0, sym1, sym2,
        num_seed_samples=args.numSeedSamples, verbose=args.verbose, device=device,
    )
    logger.info("estimated relative rotation: %.3f degrees", rel_angle)

    # write the unfolded poses for job2's particles
    e2_new = e2.copy()
    e2_new[:, 0] = rot2_unf
    new_poses = convert_euler_angles_to_cryosparc_pose(e2_new, convention="ZXZ")
    out_df = ds2.iloc[i2].reset_index(drop=True)
    out_df[pose_col] = list(new_poses)
    out_df["sym_mismatch/relative_angle"] = np.float32(rel_angle)
    out = args.outputFile2 or (Path(args.input2).stem + ".sym_mismatch.cs")
    dataframe2cs(out_df, out)
    logger.info("%d particles with unfolded poses -> %s", len(out_df), out)
    if args.outputFile1:
        e1_new = e1.copy()
        e1_new[:, 0] = rot1_unf
        out1_df = ds1.iloc[i1].reset_index(drop=True)
        out1_df[pose_col] = list(
            convert_euler_angles_to_cryosparc_pose(e1_new, convention="ZXZ")
        )
        out1_df["sym_mismatch/relative_angle"] = np.float32(rel_angle)
        dataframe2cs(out1_df, args.outputFile1)
        logger.info("dataset 1 unfolded poses -> %s", args.outputFile1)
    print(f"relative angle: {rel_angle:.3f} deg; output: {out}")


def add_args(parser):
    """The reference's argument surface, with --device."""
    parser.add_argument("-p", "--projectID", default=None,
                        help="CryoSPARC Project ID (e.g., P407)")
    parser.add_argument("-j1", "--jobID1", default=None,
                        help="First input dataset CryoSPARC Job ID")
    parser.add_argument("-j2", "--jobID2", default=None,
                        help="Second input dataset CryoSPARC Job ID")
    parser.add_argument("-i1", "--input1", default=None,
                        help="Path to local input .cs file for job 1")
    parser.add_argument("-pt1", "--pass_through1", default=None,
                        help="Path to local passthrough .cs file for job 1")
    parser.add_argument("-i2", "--input2", default=None,
                        help="Path to local input .cs file for job 2")
    parser.add_argument("-pt2", "--pass_through2", default=None,
                        help="Path to local passthrough .cs file for job 2")
    parser.add_argument("-of1", "--outputFile1", default=None,
                        help="Path to save reassigned dataset 1 locally (.cs)")
    parser.add_argument("-of2", "--outputFile2", default=None,
                        help="Path to save reassigned dataset 2 locally (.cs)")
    parser.add_argument("-s1", "--sym1", default=None,
                        help="symmetry of refinement 1 (e.g. C1)")
    parser.add_argument("-s2", "--sym2", default=None,
                        help="symmetry of refinement 2 (e.g. C6)")
    parser.add_argument("-w", "--workspaceID", default=None,
                        help="Output Workspace ID (e.g., W1)")
    parser.add_argument("--dist-tol", dest="dist_tol", type=float, default=20.0,
                        help="particle match distance tolerance (A)")
    parser.add_argument("--axis-tol", dest="axis_tol", type=float, default=10.0,
                        help="relative-rotation-axis vs +Z tolerance (deg)")
    parser.add_argument("--numSeedSamples", type=int, default=10)
    parser.add_argument("-v", "--verbose", type=int, default=2,
                        help="Verbosity level (0-2). Default 2.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the consensus search (cuda = the card; cpu)")
    return parser


def check_args(args, parser, argv=None):
    """The reference's validation rules."""
    has_input1 = args.input1 is not None
    has_job1 = args.projectID is not None and args.jobID1 is not None
    if not has_input1 and not has_job1:
        parser.error(
            "--input1 or (--projectID and --jobID1) are required for dataset 1"
        )
    has_input2 = args.input2 is not None
    has_job2 = args.projectID is not None and args.jobID2 is not None
    if not has_input2 and not has_job2:
        parser.error(
            "--input2 or (--projectID and --jobID2) are required for dataset 2"
        )
    if has_input1 and args.sym1 is None:
        parser.error("--sym1 is required when --input1 is provided")
    if has_input2 and args.sym2 is None:
        parser.error("--sym2 is required when --input2 is provided")
    if args.outputFile1 and not args.outputFile1.endswith(".cs"):
        parser.error("--outputFile1 must end with .cs")
    if args.outputFile2 and not args.outputFile2.endswith(".cs"):
        parser.error("--outputFile2 must end with .cs")
    if args.dist_tol is not None and args.dist_tol <= 0:
        parser.error("--dist-tol must be positive")
    if args.axis_tol is not None and args.axis_tol <= 0:
        parser.error("--axis-tol must be positive")
    return args


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(check_args(add_args(parser).parse_args(), parser))
