"""Whole runs of each cell on the CPU at a tiny size (the port's plain
versions): a sound run is correct, its result line has the keys the driver
reads, and a run with a fault planted under the timed path is not."""

import importlib.util
import time

import pytest

from portbench import faults
from portbench.harness import manifest, runner

SMALL = {"render": {"width": 40, "height": 24},
         "check": {"pixels": 192, "frames": 2}}
OVERRIDES = {
    "book_cover": SMALL,
    "terrain": {**SMALL, "scene": {"nx": 24, "nz": 24, "builder": "numpy"}},
    # At 96 x 54 a few paths that round apart move the loss and the norms
    # by percents (on 1080p by far less), so this size has its own limits.
    "cornell_c5": {"render": {"width": 96, "height": 54},
                   "check": {"block": 8192,
                             "limits": {"loss1_gap": 0.05, "loss_gap": 0.05,
                                        "grad_gap_median": 0.05,
                                        "change_gap": 0.3}}},
}
CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2 ** 31 + 77


def _run(cell, trace=False, seed=SEED):
    bench = manifest.load()
    cfg = manifest.cell(bench, cell)["config"]
    return runner.run(cell, seed, 2.0, trace, "cpu", time.perf_counter(),
                      overrides=OVERRIDES[cfg])


def _kind(cell):
    bench = manifest.load()
    return manifest.traffic(manifest.cell(bench, cell)["traffic"])["kind"]


def _run_py():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", manifest.PB / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    run = out.pop("run")
    assert out["correct"], run.checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench = manifest.load()
    want = {m["name"] for m in manifest.e2e_metrics(bench, cell)}
    assert set(out["metrics"]) == want
    line = _run_py().result_line(out, run, "cpu", 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def _faults(cell):
    return faults.FRAME_FAULTS if _kind(cell) == "frames" else faults.FAULTS


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in _faults(c)])
def test_planted_fault_is_not_correct(cell, fault):
    plant = faults.plant_frame if _kind(cell) == "frames" \
        else faults.plant_train
    undo = plant(fault)
    try:
        out = _run(cell)
    finally:
        undo()
    assert not out["correct"], out["run"].checks


def test_traced_run_reports_layer_metrics_on_cpu():
    out = _run(CELLS[0], trace=True)
    run = out.pop("run")
    assert run.trace_data is not None and run.traced_keys
    line = _run_py().result_line(out, run, "cpu", 1)
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["checks"]


@pytest.mark.cuda
def test_card_run_of_each_cell_is_correct(card):
    for cell in CELLS:
        out = runner.run(cell, SEED, 2.0, False, card, time.perf_counter())
        assert out["correct"], out["run"].checks
