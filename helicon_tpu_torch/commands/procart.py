#!/usr/bin/env python

"""A Web app that plots residue properties of amyloid structures in cartoons"""

import argparse
import logging

from helicon_tpu_torch.commands._launchers import run_remote_streamlit_app

logger = logging.getLogger(__name__)


def main(args):
    run_remote_streamlit_app("https://raw.githubusercontent.com/jianglab/procart/master/procart.py", "https://jianglab.science.psu.edu/procart")


def add_args(parser):
    """No additional CLI arguments for this web app launcher."""
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
