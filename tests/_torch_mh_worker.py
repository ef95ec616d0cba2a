"""Worker of the port's multi-process tests (tests/test_torch_multihost.py).

Usage: python _torch_mh_worker.py <out.json> <case>[,<case>...]
       [ckpt=<base path>] [chunk=<n>] [die=<k0,k1,...>]

The process group comes from the environment, as torchrun sets it (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK). The worker runs
multihost_reconstruct_grid on the CPU on each case's workload (CASES), one
after the other in the one group, and writes for each the gathered
scores, the best index and the refined poses as JSON. It imports only the
port (no JAX), as a process on the card would.
"""

import json
import os
import sys

# spawned as `python tests/_torch_mh_worker.py`: sys.path[0] is tests/, so
# put the repository root on the path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# refinement in nearest-neighbour interpolation, one Gauss-Newton step
REFINE = dict(tilt=4.0, psi=2.0, dy=1.0, max_iter=1)


def tiny_workload(bucketed: bool = False):
    """(image, twists, rises, kwargs): tests/_mh_worker.py's small workload,
    the image from the port's simulator (pinned to the JAX package's)."""
    from helicon_tpu_torch.helix import simulate_helical_projection

    image = simulate_helical_projection(
        n=1, twist=29.4, rise=4.75, csym=1, helical_diameter=100.0,
        ball_radius=6.0, polymer=0, planarity=1.0,
        ny=64, nx=128, apix=2.0, rng=0, device="cpu",
    )
    image = np.asarray(image, np.float32).reshape(64, 128)
    if bucketed:
        tw = np.asarray([25.0] * 2 + [29.4] * 3 + [33.0], np.float32)
        ri = np.asarray([3.0, 4.75, 3.2, 4.75, 5.6, 4.75], np.float32)
    else:
        tw = np.asarray([25.0] * 3 + [29.4] * 3 + [33.0], np.float32)
        ri = np.asarray([4.3, 4.6, 4.9, 4.4, 4.75, 5.0, 4.75], np.float32)
    kw = dict(
        apix=2.0, target_apix2d=4.0, tube_diameter=110.0,
        reconstruct_length_rise=3.0, cg_iters=8, fista_iters=8,
        power_iters=2, compute_dtype="float32", batch_size=4,
        return_best_volume=False, device="cpu",
    )
    return image, tw, ri, kw


def refine_kwargs(mode: str) -> dict:
    return dict(refine_tilt_psi_dy_range=REFINE, refine_mode=mode, refine_top_k=2)


# the cases: (two rise buckets?, the candidates, the search's extra keyword
# arguments); refine_mode "all" at tests/test_torch_refine_grid.py's
# settings for it (linear interpolation, where the JAX package's refinement
# engine and its JAX loop agree; four candidates, 5 / 5 iterations)
CASES = dict(
    bucketed=(True, slice(None), {}),
    topk=(True, slice(None), refine_kwargs("topk")),
    all=(False, slice(2, 6), dict(refine_kwargs("all"), interpolation="linear", cg_iters=5,
                                  fista_iters=5)),
)


def case_workload(name: str):
    """(image, twists, rises, kwargs) of one case."""
    bucketed, cands, extra = CASES[name]
    image, tw, ri, kw = tiny_workload(bucketed)
    return image, tw[cands], ri[cands], dict(kw, **extra)


def main():
    torch.set_num_threads(1)
    out_path, cases, extra = sys.argv[1], sys.argv[2].split(","), sys.argv[3:]
    from helicon_tpu_torch.parallel import multihost

    multihost.initialize()
    rank = int(os.environ["RANK"])
    mh_kw = {}
    for a in extra:
        if a.startswith("ckpt="):
            mh_kw["checkpoint_path"] = a[5:]
        elif a.startswith("chunk="):
            mh_kw["checkpoint_chunk"] = int(a[6:])
        elif a.startswith("die="):
            ks = [int(x) for x in a[4:].split(",")]
            if ks[rank % len(ks)] > 0:
                mh_kw["die_after_chunks"] = ks[rank % len(ks)]
    out = {}
    for name in cases:
        image, tw, ri, kw = case_workload(name)
        res = multihost.multihost_reconstruct_grid(image, twists=tw, rises=ri, **mh_kw, **kw)
        out[name] = dict(
            rank=rank,
            scores=np.asarray(res.scores, np.float64).tolist(),
            best_index=res.best_index,
            refined={str(k): list(v) for k, v in (res.refined_params or {}).items()},
            effective={k: res.effective.get(k) for k in (
                "n_processes", "card_processes", "n_buckets", "checkpointed", "chunks_run",
                "exchanges")},
        )
    with open(out_path, "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
