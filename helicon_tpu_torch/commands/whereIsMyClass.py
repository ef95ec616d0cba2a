#!/usr/bin/env python

"""A Web app that maps 2D class members back to their micrograph locations"""

import argparse
import logging

from helicon_tpu_torch.commands._launchers import run_local_shiny_app

logger = logging.getLogger(__name__)


def main(args):
    run_local_shiny_app("whereIsMyClass", "https://jianglab.science.psu.edu/helicon")


def add_args(parser):
    """No additional CLI arguments for this web app launcher."""
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
