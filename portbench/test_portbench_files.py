"""Every cell, configuration, traffic mix, check file and per-layer metric
of BENCHMARK.json, loaded by name; and the imports of the harness and the
reference, compared by whole top-level names."""

import ast
import importlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import cell as cell_mod
from portbench.harness import check

ROOT = cell_mod.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "helicon_tpu"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    c = cell_mod.load(name)
    twists, rises = c.grid()
    assert len(twists) == len(rises) > 0
    assert set(c.checks["limits"]) == set(check.NUMBERS)
    assert c.end_to_end() and c.per_layer()
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    for key in ("twist_abs", "rise"):
        lo, hi = c.traffic["truth"][key]
        assert lo <= hi


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_gives_every_search_keyword(cfg):
    from helicon_tpu_torch.denovo3d import reconstruct_grid

    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert len(data["source"]) <= 200
    params = set(inspect.signature(reconstruct_grid).parameters)
    # the image and grid come from the traffic; the rest is given
    given = set(data["search"])
    missing = params - given - {"image", "twists", "rises", "devices", "progress_callback",
                                "should_abort", "cost_analysis", "rise_bucket_ratio",
                                "geometry_rise_range", "card_processes"}
    assert not missing
    assert given <= params


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    mod = importlib.import_module(f"portbench.metrics.{metric['name']}")
    assert mod.LAYER == metric["layer"]
    assert mod.UNIT == metric["unit"]
    assert mod.MOVES == metric["moves"]
    assert mod.SOURCE == metric["source"]
    assert callable(mod.read)


def test_names_units_and_references():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_under_portbench_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "helicon_tpu_torch" not in _imports(path), path


def test_loaded_modules_by_whole_top_level_name():
    """In a fresh process: the reference loads nothing of the program, and
    the harness with the program loads neither JAX nor the JAX package
    (helicon_tpu_torch begins with helicon_tpu, so names compare whole)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.search, portbench.reference.geometry\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'helicon_tpu_torch' not in top, top\n"
        "import portbench.harness.runner, portbench.harness.check, portbench.calibrate\n"
        "import helicon_tpu_torch.denovo3d\n"
        "from portbench.harness.runner import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n"
        "assert 'helicon_tpu_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "print('ok')\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench.harness.runner import forbidden_modules

    monkeypatch.setitem(sys.modules, "helicon_tpu_torchx", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]
