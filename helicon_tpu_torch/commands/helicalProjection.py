#!/usr/bin/env python

"""A Web app that compares 2D images with helical structure projections"""

import argparse
import logging

from helicon_tpu_torch.commands._launchers import run_remote_shiny_app

logger = logging.getLogger(__name__)


def main(args):
    run_remote_shiny_app(["https://raw.githubusercontent.com/jianglab/HelicalProjection/refs/heads/main/app.py", "https://raw.githubusercontent.com/jianglab/HelicalProjection/refs/heads/main/compute.py"], "https://jianglab.science.psu.edu/HelicalProjection")


def add_args(parser):
    """No additional CLI arguments for this web app launcher."""
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
