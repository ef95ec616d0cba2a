"""A whole run on the CPU, past the harness's look for a chip, at a tiny
size: sound, it comes out correct; with the timed path broken underneath
it comes out not correct, once for each fault a cell can have (a one-chip
search exchanges nothing between chips, so that fault has no place here):

- a solve that returns its state unchanged (the start, zeros);
- half of a launch's twist groups left out, the mean of the rest taken
  for them;
- an answer altered where it is produced (one candidate's score);
- the best volume altered where it is produced.
"""

import copy
import dataclasses
import json
import time

import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness import runner


def _tiny_cell(workload="amyloid_2A_nn.cli_stack"):
    c = cell_mod.load(workload)
    c = dataclasses.replace(c, config=copy.deepcopy(c.config), traffic=copy.deepcopy(c.traffic))
    c.config["search"].update(device="cpu", cg_iters=3, fista_iters=2, power_iters=2)
    c.config["image"].update(ny=64, nx=128, balls_per_unit=12)
    if c.traffic["grid"]["rise"][0] == c.traffic["grid"]["rise"][1]:
        c.traffic["grid"] = {"twist": [1.0, 3.0, 1.0], "rise": [4.75, 4.75, 0.0]}
    else:
        c.traffic["grid"] = {"twist": [1.0, 2.0, 1.0], "rise": [4.6, 4.75, 0.15]}
    c.traffic.update(stack_size=2, check_searches=2, trace_searches=1)
    return c


def _run(capsys, cell, search=None, trace=0):
    rc = runner.run_cell(cell, 2 ** 31 + 11, 1.0, trace, torch.device("cpu"),
                         time.perf_counter(), search=search)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["amyloid_2A_nn.cli_stack", "amyloid_2A_nn.known_rise"])
def test_sound_run_is_correct(capsys, workload):
    out = _run(capsys, _tiny_cell(workload))
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"candidates_per_s", "search_s_p95", "setup_s"}


def test_traced_run_reports_per_layer_metrics(capsys):
    out = _run(capsys, _tiny_cell(), trace=1)
    assert out["correct"] is True
    # no device trace on the CPU: the device's metrics find nothing to read
    assert {"build_s", "solve_s", "outside_scoring_s", "grouped_solve_roofline"} <= set(
        out["metrics"])
    assert "device_idle_pct" not in out["metrics"]


def _patched_solve(monkeypatch, fault):
    from helicon_tpu_torch.denovo3d import group_solve

    real = group_solve.solve_group

    def broken(inp, *a, **k):
        x, s = real(inp, *a, **k)
        if fault == "unchanged":
            return torch.zeros_like(x), torch.zeros_like(s)
        if fault == "half":
            G = x.shape[0]
            keep = max(1, G // 2)
            x, s = x.clone(), s.clone()
            x[keep:] = x[:keep].mean(dim=0)
            s[keep:] = s[:keep].mean(dim=0)
            return x, s
        if fault == "score":
            s = s.clone()
            s.view(-1)[0] += 0.05
            return x, s
        raise ValueError(fault)

    monkeypatch.setattr(group_solve, "solve_group", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "score"])
def test_broken_solve_is_not_correct(capsys, monkeypatch, fault):
    _patched_solve(monkeypatch, fault)
    out = _run(capsys, _tiny_cell())
    assert out["correct"] is False


def test_altered_best_volume_is_not_correct(capsys):
    from helicon_tpu_torch.denovo3d import reconstruct_grid

    def search(image, **kw):
        res = reconstruct_grid(image, **kw)
        res.best_volume = res.best_volume * 1.01
        return res

    out = _run(capsys, _tiny_cell(), search=search)
    assert out["correct"] is False


def test_failed_search_is_counted_and_not_correct(capsys):
    def search(image, **kw):
        raise RuntimeError("planted failure")

    out = _run(capsys, _tiny_cell(), search=search)
    assert out["correct"] is False and out["failed"] == out["attempted"] > 0


def _stub_reference(monkeypatch, determined):
    """The reference stubbed so that a stack position's best volume is
    determined to float32 where it is in ``determined``."""
    from portbench.harness import check
    from portbench.reference import search as ref

    read = dict(geometry_mismatch=0.0, score_gap=0.0)
    monkeypatch.setattr(check, "compare", lambda o, image, *a: dict(
        read, volume_err=1e-6 if image in determined else None))
    monkeypatch.setattr(ref, "setup", lambda image, *a: image)
    monkeypatch.setattr(ref, "scores", lambda s: None)
    monkeypatch.setattr(check, "volume_numbers", lambda o, s: dict(
        volume_err=1e-6 if s in determined else None, volume_determinacy=0.0))
    monkeypatch.setattr(check, "numbers", lambda o, s, sc, volume: dict(read, **volume))
    return check


@pytest.mark.parametrize("determined, n_read", [({2}, 2), ({1}, 3), ({4}, 3), ({0, 4}, 2)])
def test_check_sample_reaches_a_determined_volume(monkeypatch, determined, n_read):
    """Where the sample (the first two of the seed's order) holds no best
    volume determined to float32, the searches after it are compared until
    one does, and the run is judged on it."""
    check = _stub_reference(monkeypatch, determined)
    images = [0, 1, 2, 3, 4, 5]
    order = [0, 2, 1, 3, 4, 5]
    readings = check.sample_readings({i: i for i in images}, images, order, 2, {}, None,
                                     None, "cpu")
    assert len(readings) == n_read
    worst = check.worst(readings)
    assert worst["volume_err"] == 1e-6
    assert check.judge(worst, dict(geometry_mismatch=0, score_gap=1e-3, volume_err=1e-5))


def test_run_that_compares_no_volume_is_not_correct(monkeypatch):
    check = _stub_reference(monkeypatch, set())
    images = [0, 1, 2]
    readings = check.sample_readings({i: i for i in images}, images, images, 2, {}, None,
                                     None, "cpu")
    assert len(readings) == 2
    worst = check.worst(readings)
    assert worst["volume_err"] is None
    assert not check.judge(worst, dict(geometry_mismatch=0, score_gap=1e-3, volume_err=1e-5))
