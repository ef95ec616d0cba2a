"""The host cost of a kernel launch's device guard, on one card.

Every C entry of the port's kernel library runs with its tensors' card as
the current CUDA device (``_build.Launcher``, ``gather_kernels._run``).
This times, in one process, back-to-back calls of the library's empty
entry (``hgp_empty``, one empty kernel) in microseconds of host time a
call, the card synchronised after each batch:

- the bare C call on the current stream;
- ``gather_kernels._run`` on the current card (its check, no context);
- the same call inside ``torch.cuda.device`` (what a call on another card
  pays);
- ``_build.Launcher`` on the current card (its count under the lock).

Each is timed in rounds, in turns, and the median of the rounds printed,
with the card's name and power limit. Needs one CUDA card:

    python3 tools/launch_guard_cost.py
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS, ROUNDS = 20_000, 7


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from helicon_tpu_torch import _build
    from helicon_tpu_torch.denovo3d import gather_kernels

    if not torch.cuda.is_available():
        print("launch_guard_cost: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = _build.load_kernels()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    run = _build.Launcher(dev, lambda k: None)

    def bare():
        lib.hgp_empty(stream)

    def guarded_current():
        gather_kernels._run(dev, lib.hgp_empty)

    def guarded_context():
        with torch.cuda.device(dev):
            lib.hgp_empty(stream)

    def launcher():
        run("hgp_empty")

    cases = dict(bare=bare, run_current_card=guarded_current,
                 device_context=guarded_context, launcher_current_card=launcher)
    times = {k: [] for k in cases}
    for _ in range(ROUNDS):
        for name, fn in cases.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            times[name].append((time.perf_counter() - t0) * 1e6 / CALLS)
            torch.cuda.synchronize()
    med = {k: statistics.median(v) for k, v in times.items()}
    spread = {k: max(v) - min(v) for k, v in times.items()}
    print("GUARD " + "; ".join(f"{k} {med[k]:.3f} us a call (spread {spread[k]:.3f})"
                               for k in cases) + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
