"""Entry point of the ``helicon-torch`` console command: an argparse
dispatcher over the port's subcommands, as ``helicon_tpu/commands/helicon.py``
is for the JAX package's.

  helicon-torch denovo3d_cli classes.mrcs out --twist 0.5 45 0.5 --rise 4 5 0.25
"""

from __future__ import annotations

import argparse
from importlib import import_module

import helicon_tpu_torch

cli_commands = ["denovo3d_cli"]


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
        sub.set_defaults(main_function=module.main)
    args = parser.parse_args(argv)
    args.main_function(args)


if __name__ == "__main__":
    main()
