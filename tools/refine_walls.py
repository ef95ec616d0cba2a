"""Refinement's walls on one card, from several checkouts in turns.

Each checkout given (its root: this repository, or a parent commit
unpacked with ``git archive`` into an ignored directory) runs in a
process of its own, with its own ``chip_smoke.py`` and kernel library:
phase 4's search (for phase 10 (c)'s scores), phase 9 (b) and the
refine matvec at k = 1 and k = 45 (phase 10 (a)), phase 10 (c) (the
CLI's refinement), phase 10 (d) (refine_mode "all"), five runs of phase
12 (a)'s refined web-app task at the app's budget (120 / 120 / 8), and
one Gauss-Newton step at tilt 3 deg timed over 20 steps, three times.
Give the checkouts in an order that alternates them, e.g. a parent and
this tree:

    python3 tools/refine_walls.py build/parent . . build/parent

Each run prints its card (nvidia-smi's name and power limit) and one
summary line starting ``WALLS``; the phases print their own lines.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def _measure(tag: str) -> None:
    """The walls of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from helicon_tpu_torch import _build
    from helicon_tpu_torch.denovo3d import refine

    _build.load_kernels()
    device = torch.device("cuda", 0)
    card = cs._card_line()
    print(f"== {tag} {os.getcwd()} {card}", flush=True)
    res, _ = cs.phase_real_size(device)
    scores = res.scores
    del res
    tilted = cs.phase_tilted(device)
    share = cs.phase_sym_share(device, tilted, card)
    cli = cs.phase_refine_cli(device, scores, card)
    every = cs.phase_refine_all(device, card)
    task = dict(cs.WEBAPP_TASK, data=np.load(cs.AMYLOID), tilt_range=(-5.0, 5.0))
    refines = []
    for i in range(5):
        _, wall, parts, launches, _ = cs._run_task(task, device)
        refines.append(parts["refine"])
        print(f"{tag} phase 12 (a), the refined task at the app's budget, run {i}: "
              f"{cs._parts_text(wall, parts)}; launches {launches}", flush=True)
    geom, tw, rp, copies, _ = tilted["golden"]
    x = torch.rand((1,) + geom.volume_shape, device=device)
    step = (geom, np.random.default_rng(12).random((geom.d2, geom.l2)).astype(np.float32),
            np.float32([tw]), np.float32([rp]), tuple(np.asarray(c)[None] for c in copies), x,
            np.float32([[3.0, 0.0, 0.0]]))
    steps = []
    for _ in range(3):
        refine.gn_step(*step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            refine.gn_step(*step)
        steps.append((time.perf_counter() - t0) * 1e3 / 20)
    print(f"WALLS {tag}: the CLI's refine_s {cli['refine_s']:.4f} s; refine_mode all wall "
          f"{every['wall']:.4f} s; refine matvec k=1 {share[1]['matvec_ms']:.4f} ms, k=45 "
          f"{share[45]['matvec_ms']:.4f} ms; the refined task's refine "
          f"{[round(v, 4) for v in refines]} s; a Gauss-Newton step "
          f"{[round(v, 4) for v in steps]} ms; {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", help="checkout roots, run in this order")
    ap.add_argument("--one", help="measure the checkout in the working directory as TAG")
    args = ap.parse_args()
    if args.one:
        _measure(args.one)
        return 0
    roots = [os.path.abspath(c) for c in args.checkouts]
    here = os.path.abspath(__file__)
    # every checkout's kernels built first, all together
    build = "import sys; sys.path.insert(0, '.'); from helicon_tpu_torch import _build; " \
            "_build.load_kernels()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=r) for r in dict.fromkeys(roots)]
    if any(p.wait() for p in procs):
        return 1
    for i, root in enumerate(roots):
        tag = f"{os.path.relpath(root)}#{i}"
        if subprocess.run([sys.executable, here, "--one", tag], cwd=root).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
