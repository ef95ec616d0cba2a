#!/usr/bin/env python

"""A Web app for helical indexing using Fourier layer lines of 2D images"""

import argparse
import logging

from helicon_tpu_torch.commands._launchers import run_remote_shiny_app

logger = logging.getLogger(__name__)


def main(args):
    run_remote_shiny_app(["https://raw.githubusercontent.com/jianglab/HILL/refs/heads/main/app.py", "https://raw.githubusercontent.com/jianglab/HILL/refs/heads/main/compute.py", "https://raw.githubusercontent.com/jianglab/HILL/refs/heads/main/util.py"], "https://jianglab.science.psu.edu/HILL")


def add_args(parser):
    """No additional CLI arguments for this web app launcher."""
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
