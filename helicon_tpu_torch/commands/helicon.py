"""Entry point of the ``helicon-torch`` console command: an argparse
dispatcher over the port's subcommands, as ``helicon_tpu/commands/helicon.py``
is for the JAX package's.

  helicon-torch denovo3d_cli classes.mrcs out --twist 0.5 45 0.5 --rise 4 5 0.25
  helicon-torch images2star in.star out.star --select rlnClassNumber 1 --device cpu
  helicon-torch proc3d in.mrc out.mrc --flip_hand z --device cpu
  helicon-torch trueFSC half1.mrc half2.mrc fsc.pdf
"""

from __future__ import annotations

import argparse
import logging
import sys
from importlib import import_module

import helicon_tpu_torch
from helicon_tpu_torch.utils.exceptions import HeliconError, HeliconExit

logger = logging.getLogger(__name__)

cli_commands = ["denovo3d_cli", "images2star", "proc3d", "trueFSC"]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="helicon-tpu-torch: the PyTorch / CUDA port of helicon-tpu")
    parser.add_argument("--version", action="version",
                        version="helicon-torch " + helicon_tpu_torch.__version__)
    subparsers = parser.add_subparsers(title="Choose a command", required=True)
    for name in cli_commands:
        module = import_module(f"helicon_tpu_torch.commands.{name}")
        doc = (module.__doc__ or "").split("\n")
        sub = subparsers.add_parser(name, help=doc[0], description=doc[0],
                                    epilog="\n".join(doc[1:]),
                                    formatter_class=argparse.RawDescriptionHelpFormatter)
        module.add_args(sub)
        sub.set_defaults(main_function=module.main, this_parser=sub,
                         check_args_function=getattr(module, "check_args", None))
    args = parser.parse_args(argv)
    try:
        if args.check_args_function is not None:
            # the option plan reads the command line after the dispatcher's
            # own argv[0]: the subcommand's name starts no option
            args = args.check_args_function(args, args.this_parser,
                                            sys.argv[1:] if argv is None else list(argv))
        args.main_function(args)
    except HeliconExit:
        sys.exit(0)
    except HeliconError as e:
        logger.error("ERROR: %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
