"""Command-audit and timing helpers of the port.

A copy of ``color_print``, ``getLogger``, ``log_command_line``,
``timedelta2string`` and ``Timer`` from ``helicon_tpu/utils/logging.py``,
without the JAX profiler annotation. tests/test_torch_io.py and
tests/test_torch_namespace.py pin the copy to the original.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
import time

__all__ = ["Timer", "color_print", "getLogger", "log_command_line", "timedelta2string"]

_COLORS = {
    "black": 30,
    "red": 31,
    "green": 32,
    "yellow": 33,
    "blue": 34,
    "magenta": 35,
    "cyan": 36,
    "white": 37,
}


def color_print(*args, color: str = "red", **kwargs) -> None:
    """Print with ANSI color when stdout is a terminal."""
    code = _COLORS.get(color, 31)
    if sys.stdout.isatty():
        print(f"\033[{code}m", end="")
        print(*args, **kwargs)
        print("\033[0m", end="", flush=True)
    else:
        print(*args, **kwargs)


def getLogger(
    logfile: str | None = None, verbose: int = 1, name: str = "helicon"
) -> logging.Logger:
    """Logger with an optional file handler and a console handler.

    verbose<=0 -> WARNING, 1 -> INFO, >=2 -> DEBUG on the console.
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:  # close old file handlers: clear() alone
        h.close()  # leaks one fd per getLogger(logfile=...) call
    logger.handlers.clear()

    console = logging.StreamHandler()
    console.setLevel(
        logging.WARNING if verbose <= 0 else logging.INFO if verbose == 1 else logging.DEBUG
    )
    console.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(console)

    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(fh)
    return logger


def log_command_line(logfile: str = "helicon.log") -> None:
    """Append the current command line (with timestamp and cwd) to *logfile*."""
    try:
        with open(logfile, "a") as fp:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            fp.write(f"{stamp}\t{os.getcwd()}\t{' '.join(sys.argv)}\n")
    except OSError:
        pass


def timedelta2string(td, verbose: int = 2) -> str:
    """Render a duration (a timedelta or seconds) as e.g. ``1h 2m 3.4s``,
    keeping *verbose* fields."""
    total = td.total_seconds() if hasattr(td, "total_seconds") else float(td)
    sign = "-" if total < 0 else ""
    total = abs(total)
    days, rem = divmod(total, 86400)
    hours, rem = divmod(rem, 3600)
    minutes, seconds = divmod(rem, 60)
    fields = []
    if days:
        fields.append(f"{int(days)}d")
    if hours or fields:
        fields.append(f"{int(hours)}h")
    if minutes or fields:
        fields.append(f"{int(minutes)}m")
    fields.append(f"{seconds:.1f}s")
    kept = fields[: max(1, verbose)] if len(fields) > verbose else fields
    return sign + " ".join(kept)


class Timer:
    """Context manager that logs the wall-clock time of a stage on the
    ``helicon`` logger; ``elapsed`` (also ``interval``) holds the seconds."""

    def __init__(self, name: str = "", verbose: bool | int = True,
                 logger: logging.Logger | None = None, info: str | None = None):
        self.name = info if info is not None else name
        self.info = self.name
        self.verbose = verbose
        self.logger = logger or logging.getLogger("helicon")
        self.elapsed = 0.0
        self.start = 0.0
        self.end = 0.0
        self.interval = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.start = self.t0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        self.end = self.t0 + self.elapsed
        self.interval = self.elapsed
        if self.verbose:
            td = datetime.timedelta(seconds=self.elapsed)
            self.logger.info("%s: %s", self.name, timedelta2string(td))
        return False
