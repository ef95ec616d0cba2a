"""Readings that the correctness limits of a cell are set from, on the chip.

    python3 portbench/calibrate.py --workload <name> [--control <k>] [--first <i>] [--last <j>]

In one process, for each class average of the cell's pool (every image a
run can search and check, whatever its seed): the program's search, as
the window makes it, compared with the float32 reference (the program's
readings, whose largest is a limit's lower reading); for the first k
images, the control in the program's place (the reference one precision
below the configuration's: float8 scoring, TF32 products in the best
volume), whose smallest reading is a limit's upper reading. One JSON line
per image on standard output. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--last", type=int, default=-1)
    args = p.parse_args(argv)
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import check, runner, window
    from portbench.harness import traffic as traffic_mod

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    runner.cache_dirs()
    from helicon_tpu_torch import _build
    from helicon_tpu_torch.denovo3d import reconstruct_grid

    _build.load_kernels()
    dev = torch.device("cuda", 0)
    c = cell_mod.load(args.workload)
    twists, rises = c.grid()
    kw = c.search_kwargs
    stack = traffic_mod.pool(c.config["image"], c.traffic, dev)
    window.search_once(reconstruct_grid, traffic_mod.warm_image(c.config["image"], c.traffic,
                                                                dev), twists, rises, kw, -1)
    last = len(stack.images) if args.last < 0 else args.last
    for i in range(args.first, last):
        image = stack.images[i]
        row = dict(index=i, truth=[float(stack.twists[i]), float(stack.rises[i])])
        rec, o = window.search_once(reconstruct_grid, image, twists, rises, kw, i)
        row["wall_s"] = rec.wall_s
        torch.cuda.empty_cache()
        s, sc = check.reference(image, kw, twists, rises, dev)
        row["program"] = check.numbers(o, s, sc) if o is not None else "failed"
        if i < args.control:
            row["control"] = check.numbers(check.control_outcome(s), s, sc)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main(sys.argv[1:]))
