"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the program
(``helicon_tpu_torch``) beside this folder.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness.runner import main

    sys.exit(main(sys.argv[1:], T_START))
