"""A command line tool that analyzes/transforms dataset metadata files

The port's counterpart of ``helicon_tpu/commands/images2star.py``: reads
particles or micrographs from STAR/CS/CSV/cisTEM/MRC files, applies the
options in their command-line order, and writes STAR/CS/CSV output. The
metadata stays pandas on the host; the options that touch pixels
(createStack, calibratePixelSize, extractHelices, maskGold,
denoiseCurvelet) run on --device (the card by default).

Example:
  python -m helicon_tpu_torch.commands.images2star in.star out.star \\
      --select rlnClassNumber 1 --sortby rlnMicrographName \\
      --createStack particles.mrcs:rescale2size=128
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..utils.exceptions import (
    HeliconError,
    HeliconFileExistsError,
    HeliconValidationError,
)

logger = logging.getLogger(__name__)


def main(args: argparse.Namespace) -> None:
    from ..core.analysis import estimate_inter_segment_distance
    from ..io.metadata import dataframe2file, images2dataframe
    from ..ops.images2star import dispatch
    from ..utils.collections import first_matched_attr, unique_attr_name
    from ..utils.logging import log_command_line
    from ..utils.path_utils import convert_dataframe_file_path
    from ..io.metadata import get_relion_project_folder
    from . import command_device

    log_command_line()
    command_device(args.device)
    level = (
        logging.ERROR
        if args.verbose <= 0
        else logging.WARNING
        if args.verbose == 1
        else logging.INFO
        if args.verbose == 2
        else logging.DEBUG
    )
    try:
        from rich.logging import RichHandler

        handler = RichHandler(show_time=False, show_path=False)
    except ImportError:
        handler = logging.StreamHandler()
    handler.setLevel(level)
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    data = images2dataframe(
        args.input_imageFiles,
        csparc_passthrough_files=args.csparcPassthroughFiles,
        alternative_folders=args.folder,
        ignore_bad_particle_path=args.ignoreBadParticlePath,
        ignore_bad_micrograph_path=args.ignoreBadMicrographPath,
        warn_missing_ctf=1,
        target_convention="relion",
    )
    optics = data.attrs.get("optics")

    if args.verbose:
        image_name = first_matched_attr(
            data, attrs="rlnImageName rlnMicrographName rlnMicrographMovieName".split()
        )
        if image_name:
            tmpCol = unique_attr_name(data, attr_prefix=image_name)
            data[tmpCol] = data[image_name].str.split("@", expand=True).iloc[:, -1]
            nMicrographs = data[tmpCol].nunique()
            if "rlnHelicalTubeID" in data:
                nHelices = len(data.groupby([tmpCol, "rlnHelicalTubeID"]))
                med, mean, sigma, n_all = estimate_inter_segment_distance(data)
                logger.info(
                    "Read %d segments in %d helices from %d micrographs",
                    len(data), nHelices, nMicrographs,
                )
                if med is not None and sigma > med:
                    logger.warning(
                        "filaments look fragmented (Select2D/3D); consider "
                        "--recoverFullFilaments"
                    )
            else:
                logger.info(
                    "Read %d rows from %d micrographs in %d files",
                    len(data), nMicrographs, len(args.input_imageFiles),
                )
            data.drop(columns=[tmpCol], inplace=True)

    if getattr(args, "micrographStar", None) and "rlnMicrographName" in data:
        # remap CS micrograph paths to the reference STAR's paths
        # (reference images2star.py:168-201)
        from ..io.metadata import clean_cs_micrograph_path
        from ..io.star import read_star

        blocks = read_star(args.micrographStar)
        ref = next(
            (
                blocks[k]
                for k in ("particles", "micrographs", "")
                if k in blocks and hasattr(blocks[k], "columns")
            ),
            next((v for v in blocks.values() if hasattr(v, "columns")), None),
        )
        if ref is None or "rlnMicrographName" not in ref:
            raise HeliconError(
                f"--micrographStar file {args.micrographStar} has no "
                "rlnMicrographName column"
            )
        path_map = {
            Path(str(p).split("@")[-1]).name: p
            for p in ref["rlnMicrographName"].unique()
        }

        def _map_path(cs_path):
            key = clean_cs_micrograph_path(str(cs_path))
            if key in path_map:
                return path_map[key]
            logger.warning(
                "No matching micrograph in reference STAR for %s (cleaned: %s)",
                cs_path, key,
            )
            return cs_path

        data["rlnMicrographName"] = data["rlnMicrographName"].apply(_map_path)

    if len(data) == 0:
        raise HeliconError("nothing to do with 0 particles")

    if args.first or args.last > 0:
        first = args.first if 0 < args.first < len(data) else 0
        last = args.last if first < args.last < len(data) else len(data)
        attrs = dict(data.attrs)
        data = data.iloc[first:last].reset_index(drop=True)
        data.attrs.update(attrs)

    index_d = {o: 0 for o in args.all_options}
    for option_name in args.all_options:
        if option_name in args.append_options:
            param = args.__dict__[option_name][index_d[option_name]]
        else:
            param = args.__dict__[option_name]
        if args.verbose:
            logger.info("%s: %s", option_name, param)
        data, index_d = dispatch(option_name, data, args, index_d, param)

    if args.path not in ("absolute", "abs", "real"):
        proj = get_relion_project_folder(str(Path(args.output_starFile).resolve()))
        if proj:
            for attr in ("rlnImageName", "rlnMicrographName"):
                if attr in data:
                    data[attr] = convert_dataframe_file_path(
                        data, attr, to="relative", relpath_start=proj
                    )

    if args.splitNumSets > 1:
        _split_and_save(data, data.attrs.get("optics"), args)
    else:
        dataframe2file(data, args.output_starFile)
        if args.verbose:
            logger.info("%d images saved to %s", len(data), args.output_starFile)


def _split_and_save(data, optics, args):
    """Split into N subsets by evenodd/random/micrograph/helicaltube with
    greedy balancing (reference images2star.py:246-297).

    Deviation (documented): `optics` is the LIVE post-pipeline optics
    table — the reference captures it before the option pipeline, so
    ops that rebuild the optics (assignOpticGroup*) produced subset
    files referencing groups absent from their optics block.
    """
    from ..io.metadata import dataframe2file

    # normalize to a RangeIndex: group labels below are consumed with
    # iloc, and filtering ops may leave a sparse index behind
    attrs0 = dict(data.attrs)
    data = data.reset_index(drop=True)
    data.attrs.update(attrs0)
    subsets = [[] for _ in range(args.splitNumSets)]
    if args.splitMode in ("micrograph", "helicaltube"):
        var = {
            "micrograph": "rlnMicrographName",
            "helicaltube": "rlnHelicalTubeID",
        }[args.splitMode]
        if var not in data:
            raise HeliconError(f"--splitMode={args.splitMode} requires {var}")
        if var == "rlnHelicalTubeID":
            var = ["rlnMicrographName", "rlnHelicalTubeID"]
        groups = sorted(
            data.groupby(var, sort=False), key=lambda x: len(x[1]), reverse=True
        )
        for _, g in groups:
            smallest = min(subsets, key=len)
            smallest += list(g.index)
    else:
        if args.splitMode == "random":
            attrs = dict(data.attrs)
            data = data.sample(frac=1).reset_index(drop=True)
            data.attrs.update(attrs)
        for si in range(args.splitNumSets):
            subsets[si] = list(range(si, len(data), args.splitNumSets))
    out = Path(args.output_starFile)
    # keep the output DIRECTORY: bare .stem would drop "results/" and
    # write the subsets into the CWD (a reference-inherited misplacement)
    prefix, suffix = out.parent / out.stem, out.suffix
    for si, subset in enumerate(subsets):
        if args.splitNumSets == 2 and args.splitMode == "evenodd":
            name = f"{prefix}.{['e', 'o'][si]}{suffix}"
        else:
            name = f"{prefix}.subset-{si}{suffix}"
        ds = data.iloc[subset, :]
        if "rlnImageName" in ds:
            ds = ds.sort_values(["rlnImageName"], ascending=True)
        ds = ds.reset_index(drop=True)
        ds["rlnRandomSubset"] = si + 1
        ds.attrs["optics"] = optics
        ds.attrs["convention"] = "relion"
        dataframe2file(ds, name)
        if args.verbose:
            logger.info("Subset %d/%d: %d images -> %s", si + 1,
                        args.splitNumSets, len(ds), name)


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("input_imageFiles", nargs="+", help="input image file(s)")
    parser.add_argument("output_starFile", help="output star file name")
    parser.add_argument(
        "--csparcPassthroughFiles", metavar="<filename>", type=str, nargs="+",
        help="input cryosparc v2 passthrough file(s)", default=[],
    )
    parser.add_argument(
        "--ppid", metavar="<n>", type=int, default=-1,
        help="parent-process PID (accepted for reference CLI compatibility; "
        "commands/images2star.py:459-465)",
    )
    parser.add_argument("--first", type=int, metavar="<n>", default=0,
                        help="first image to process")
    parser.add_argument("--last", type=int, metavar="<n>", default=-1,
                        help="last image to process")
    parser.add_argument("--splitNumSets", metavar="<n>", type=int, default=1,
                        help="number of subsets to split into")
    splitMode = ["evenodd", "random", "micrograph", "helicaltube"]
    parser.add_argument(
        "--splitMode", metavar=f"<{'|'.join(splitMode)}>", type=str,
        choices=splitMode, default="evenodd", help="how to split the image set",
    )
    parser.add_argument("--ignoreBadParticlePath", metavar="<0|1|2|3>", type=int,
                        default=0, help="ignore bad particle image file paths")
    parser.add_argument("--ignoreBadMicrographPath", metavar="<0|1>", type=int,
                        default=1, help="ignore bad micrograph file paths")
    parser.add_argument("--tag", metavar="<str>", type=str, default="",
                        help="tag for new binary image files")
    parser.add_argument("--folder", metavar="<path>", type=str, nargs="+",
                        default=[], help="alternative folders to search")
    parser.add_argument("--micrographStar", metavar="<file>", type=str,
                        default=None, help="reference star for micrograph paths")
    parser.add_argument("--force", type=int, metavar="<0|1>", default=0,
                        help="force overwrite the output file")
    parser.add_argument("--verbose", type=int, metavar="<0|1|2|3>", default=2,
                        help="verbose level")
    parser.add_argument("--cpu", type=int, metavar="<n>", default=-1,
                        help="accepted for compatibility (torch owns threading)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the pixel options (cuda = the card; cpu)")

    from ..ops.images2star import add_plugin_args

    add_plugin_args(parser)
    return parser


def check_args(args, parser, argv=None):
    """The option plan (the options of argv, by default sys.argv[1:], in
    their command-line order, abbreviations resolved, the command's own
    flags left out) and the output path's checks."""
    from ..utils.system import get_option_list

    args.append_options = [
        a.dest for a in parser._actions if type(a) is argparse._AppendAction
    ]
    all_options = get_option_list(sys.argv[1:] if argv is None else argv)
    # argparse (allow_abbrev) accepts unique prefixes; resolve them so
    # the execution plan carries FULL option names (an abbreviation
    # reaching dispatch() crashed mid-pipeline after data load)
    from ..utils.system import resolve_option_abbreviations

    all_options = resolve_option_abbreviations(
        all_options, [a.dest for a in parser._actions]
    )
    skip = (
        "cpu device first force ignoreBadParticlePath ignoreBadMicrographPath last "
        "folder splitNumSets splitMode micrographStar tag verbose "
        "csparcPassthroughFiles subset ppid"
    ).split()
    args.all_options = [o for o in all_options if o not in skip]

    if Path(args.output_starFile).suffix not in (".star", ".cs", ".csv"):
        raise HeliconValidationError(
            f"the output file ({args.output_starFile}) must be .star/.cs/.csv"
        )
    if Path(args.output_starFile).exists() and not (
        args.force == 1 or args.splitNumSets > 1
    ):
        raise HeliconFileExistsError(
            f"the output file ({args.output_starFile}) exists; use --force=1"
        )
    if getattr(args, "setCTF", "") and not Path(args.setCTF).exists():
        raise HeliconValidationError(f"--setCTF {args.setCTF}: file not found")
    return args


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    args = add_args(parser).parse_args()
    args = check_args(args, parser)
    main(args)
