"""Shared launcher helpers for web-app commands: spawn shiny / streamlit
on the port's own apps (``webApps/<app>/app.py``) or on downloaded ones.

A copy of ``helicon_tpu/commands/_launchers.py`` (reference:
commands/{denovo3D,hill,ctfSimulation,map2seq}.py, denovo3D.py:11-25,
hill.py:14-31, ctfSimulation.py:14-18, map2seq.py:14-17).
"""

from __future__ import annotations

import logging
import subprocess
import tempfile
from pathlib import Path

logger = logging.getLogger(__name__)


def _shiny_argv(app_file) -> list:
    # argv list with shell=False: paths with shell metacharacters stay literal
    return [
        "shiny",
        "run",
        "--launch-browser",
        "--no-dev-mode",
        "--host",
        "0.0.0.0",
        "--port",
        "0",
        str(app_file),
    ]


def run_local_shiny_app(app_name: str, homepage: str):
    """shiny run on an in-repo webApps/<app_name>/app.py."""
    try:
        app_file = Path(__file__).parent.parent / "webApps" / app_name / "app.py"
        subprocess.call(_shiny_argv(app_file))
    except Exception:
        logger.error("Please visit %s for more information", homepage)


def download_files(urls):
    from ..utils.path_utils import download_file_from_url

    folder = Path(tempfile.mkdtemp(prefix="helicon_app_"))
    for url in urls:
        download_file_from_url(url, target_file_name=str(folder / Path(url).name))
    return folder


def run_remote_shiny_app(urls, homepage: str):
    try:
        folder = download_files(urls)
        subprocess.call(_shiny_argv(folder / "app.py"))
    except Exception:
        logger.error(
            "ERROR running a local instance. Please visit %s instead", homepage
        )


def run_remote_streamlit_app(url: str, homepage: str):
    try:
        subprocess.call(["streamlit", "run", url])
    except Exception:
        logger.error(
            "ERROR running a local instance. Please visit %s instead", homepage
        )


def open_hosted_app(url: str):
    import webbrowser

    webbrowser.open(url)
