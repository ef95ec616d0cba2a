#!/usr/bin/env python

"""A Web app that identifies proteins best matching a 3D map"""

import argparse
import logging

from helicon_tpu_torch.commands._launchers import open_hosted_app

logger = logging.getLogger(__name__)


def main(args):
    open_hosted_app("https://map2seq.streamlit.app/")


def add_args(parser):
    """No additional CLI arguments for this web app launcher."""
    return parser


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    main(add_args(parser).parse_args())
