"""A command line tool that analyzes/transforms 3D maps

The port's counterpart of ``helicon_tpu/commands/proc3d.py``: the options
run in their command-line order on the map, which stays on --device (the
card by default) from the first option to the last.

Example:
  python -m helicon_tpu_torch.commands.proc3d in.mrc out.mrc \\
      --fft_resample new_nx=256:new_ny=256:new_nz=256 \\
      --helical_sym twist=-1.2:rise=4.75:center_fraction=0.3 --flip_hand z
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

from ..utils.exceptions import HeliconFileExistsError

logger = logging.getLogger(__name__)


def main(args: argparse.Namespace) -> None:
    import torch

    from ..io.mrc import read_mrc, write_mrc
    from ..ops.proc3d import dispatch
    from ..utils.logging import log_command_line
    from . import command_device

    log_command_line()
    logging.basicConfig(
        level=(
            logging.DEBUG
            if args.verbose > 2
            else logging.INFO if args.verbose > 0 else logging.ERROR
        ),
        format="%(message)s",
        stream=sys.stdout,
    )

    device = command_device(args.device)
    data, apix = read_mrc(args.inputMapFile)
    data = torch.as_tensor(np.asarray(data, np.float32), device=device)
    nz, ny, nx = data.shape
    apix = round(float(apix), 4)
    if args.verbose > 0:
        logger.info(
            "Input map: %s (%dx%dx%d pixels, %g A/pixel)",
            args.inputMapFile, nx, ny, nz, apix,
        )

    index_d = {o: 0 for o in args.all_options}
    for option_name in args.all_options:
        if option_name in args.append_options:
            param = args.__dict__[option_name][index_d[option_name]]
        else:
            param = args.__dict__[option_name]
        if args.verbose:
            logger.info("%s: %s", option_name, param)
        data, apix, nx, ny, nz = dispatch(
            option_name, data, args, index_d, param, apix, nx, ny, nz
        )

    if args.verbose > 1:
        logger.info(
            "Output map: %s (%dx%dx%d pixels, %g A/pixel)",
            str(args.outputMapFile), nx, ny, nz, apix,
        )
    write_mrc(args.outputMapFile, data.cpu().numpy().astype(np.float32), apix=apix)


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument(
        "inputMapFile", type=str, metavar="<inputMapFile>",
        help="input 3D map file in MRC format",
    )
    parser.add_argument(
        "outputMapFile", type=str, nargs="?", metavar="<outputMapFile>",
        default=None, help="output 3D map file",
    )
    parser.add_argument(
        "--outputMapFile", type=str, dest="outputMapFile_opt",
        metavar="<filename>", help=argparse.SUPPRESS, default="",
    )
    parser.add_argument("--force", type=int, metavar="<0|1>", default=0,
                        help="force overwrite the output file")
    parser.add_argument("--verbose", type=int, metavar="<0|1|2>", default=2,
                        help="verbose level")
    parser.add_argument("--cpu", type=int, metavar="<n>", default=-1,
                        help="accepted for compatibility (torch owns threading)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the map (cuda = the card; cpu)")

    from ..ops.proc3d import add_plugin_args

    add_plugin_args(parser)
    return parser


def check_args(args, parser, argv=None):
    """The option plan: the options in their command-line order (argv, by
    default sys.argv[1:]), abbreviations resolved to their full names,
    the command's own flags left out; and the output path."""
    from ..utils.system import get_option_list, resolve_option_abbreviations

    args.append_options = [
        a.dest for a in parser._actions if type(a) is argparse._AppendAction
    ]
    all_options = get_option_list(sys.argv[1:] if argv is None else argv)
    # argparse (allow_abbrev) accepts unique prefixes; resolve them so the
    # plan carries full option names (an abbreviation reaching dispatch()
    # would fail mid-pipeline after the data load)
    all_options = resolve_option_abbreviations(
        all_options, [a.dest for a in parser._actions]
    )
    # get_option_list yields flag names ("outputMapFile"), not argparse
    # dests ("outputMapFile_opt"): both are left out of the plan
    args.all_options = [
        o
        for o in all_options
        if o not in ("cpu device force inputMapFile outputMapFile outputMapFile_opt "
                     "verbose").split()
    ]
    if args.outputMapFile is not None:
        args.outputMapFile = Path(args.outputMapFile)
    elif args.outputMapFile_opt:
        args.outputMapFile = Path(args.outputMapFile_opt)
    else:
        args.outputMapFile = Path(args.inputMapFile).with_suffix(".proc3d.mrc")
    if args.outputMapFile.exists() and not args.force:
        raise HeliconFileExistsError(
            f"output file {args.outputMapFile} exists; use --force"
        )
    return args


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    args = add_args(parser).parse_args()
    args = check_args(args, parser)
    main(args)
