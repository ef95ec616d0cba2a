"""A cell of the benchmark, found by its name: its entry in BENCHMARK.json,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its correctness limits
(``checks/<workload>.json``)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    checks: dict
    benchmark: dict

    @property
    def search_kwargs(self) -> dict:
        """The keywords the window passes to reconstruct_grid, besides the
        image and the grid."""
        return dict(self.config["search"])

    def grid(self):
        """(twists, rises) float32 of the traffic's candidate grid."""
        from ..reference.geometry import build_candidate_grid

        g = self.traffic["grid"]
        twists, rises = build_candidate_grid(*g["twist"], *g["rise"],
                                             handedness=g.get("handedness", "both"))
        if g.get("order") == "lexsort":
            order = np.lexsort((rises, twists))
            twists, rises = twists[order], rises[order]
        n = g.get("first")
        return (twists[:n], rises[:n]) if n else (twists, rises)

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports."""
        return [m for m in self.benchmark["per_layer"]
                if "workloads" not in m or self.name in m["workloads"]]

    def end_to_end(self) -> list:
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell named ``name`` of BENCHMARK.json in root."""
    bench = _load(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; it has {sorted(entries)}")
    entry = entries[name]
    return Cell(name=name, entry=entry,
                config=_load(BENCH_DIR / "configs" / f"{entry['config']}.json"),
                traffic=_load(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
                checks=_load(BENCH_DIR / "checks" / f"{name}.json"), benchmark=bench)
