#!/usr/bin/env python3
"""Start-up of the port's commands in two checkouts, timed in one process.

    python3 tools/command_startup.py PARENT_CHECKOUT CHANGE_CHECKOUT

Each ``python -m helicon_tpu_torch.commands.<name> --help`` (its imports,
then exit) runs in the order parent, change, change, parent, three
rounds, so that both checkouts see the same machine; prints every wall
and each side's median per command. Run it on the card's machine, where
the imports load torch's CUDA libraries.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

COMMANDS = ["proc3d", "trueFSC", "denovo3d_cli", "images2star", "HOM_containerC"]


def main(parent: str, change: str, rounds: int = 3) -> None:
    trees = {"parent": Path(parent).resolve(), "change": Path(change).resolve()}
    walls = {side: {c: [] for c in COMMANDS} for side in trees}
    for _ in range(rounds):
        for side in ("parent", "change", "change", "parent"):
            for c in COMMANDS:
                t0 = time.perf_counter()
                r = subprocess.run([sys.executable, "-m", f"helicon_tpu_torch.commands.{c}",
                                    "--help"], cwd=trees[side], capture_output=True, text=True)
                walls[side][c].append(time.perf_counter() - t0)
                if r.returncode != 0:
                    raise SystemExit(f"{side} {c} exited {r.returncode}: {r.stderr[-2000:]}")
    for side in trees:
        print(side, json.dumps({c: [round(v, 3) for v in vs] for c, vs in walls[side].items()}))
        print(side, "median", json.dumps({c: round(sorted(vs)[len(vs) // 2], 3)
                                          for c, vs in walls[side].items()}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
