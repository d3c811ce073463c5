"""Whole runs of each cell on the CPU at a tiny size (the port's plain
versions; a sharded cell's ranks as gloo processes): a sound run is
correct, its result line has the keys the driver reads, a run with a fault
planted under the timed path is not, nor one whose configuration names a
reference that renders otherwise, and a rank that fails ends the run."""

import importlib.util
import multiprocessing
import os
import pathlib
import sys
import time
import types
from multiprocessing import resource_tracker

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
# grad_gap[camera/translate] at 96 x 54 on the CPU: sound 0.00014-0.134
# over 13 seeds; "half_batch" 0.748-3.35 over 5, "altered" 0.109-0.364.
LEAF_LIMIT = 0.35
CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2 ** 31 + 77
# Windows long enough that a step lands in them on a loaded CPU (a 96 x 54
# train step took 1.6-2.0 s there).
SECONDS = {"frames": 2.0, "train_steps": 8.0, "train_steps_sharded": 8.0}
SHARDED = "train_steps_sharded"


def _kind(cell):
    bench = manifest.load()
    return manifest.traffic(manifest.cell(bench, cell)["traffic"])["kind"]


def _run(cell, trace=False, seed=SEED, fault=None, more=None):
    """One run of the cell at its test size; more: overrides merged over
    the test size's."""
    bench = manifest.load()
    cfg = manifest.cell(bench, cell)["config"]
    over = manifest._merge(OVERRIDES[cfg], more or {})
    return runner.run(cell, seed, SECONDS[_kind(cell)], trace, "cpu",
                      time.perf_counter(), overrides=over, fault=fault)


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
    kind = _kind(cell)
    if kind == "frames":
        return faults.FRAME_FAULTS
    return faults.FAULTS + (faults.SHARD_FAULTS if kind == SHARDED else ())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in _faults(c)])
def test_planted_fault_is_not_correct(cell, fault):
    if _kind(cell) == SHARDED:
        out = _run(cell, fault=fault)
        assert not out["correct"], out["run"].checks
        return
    plant = faults.plant_frame if _kind(cell) == "frames" \
        else faults.plant_train
    undo = plant(fault)
    try:
        out = _run(cell)
    finally:
        undo()
    assert not out["correct"], out["run"].checks


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if _kind(c).startswith("train_steps")])
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the port's place fails the cell's
    numbers (the sharded cell's target too) at the test size."""
    import torch

    from portbench.harness import check, inputs, ranks
    from portbench.reference import tracer

    bench = manifest.load()
    w = manifest.cell(bench, cell)
    cfg = manifest.config(bench, w["config"], OVERRIDES[w["config"]])
    traffic = manifest.traffic(w["traffic"])
    n = int(traffic["setup_steps"])
    base = {"keys": inputs.unit_keys(SEED, n),
            "tkey": inputs.target_key(SEED),
            "true_inputs": inputs.scene_inputs(cfg["scene"]),
            "start_inputs": inputs.scene_inputs(cfg["scene"],
                                                cfg["train"]["start"])}
    dev = torch.device("cpu")
    ref = runner.reference_steps(base, cfg, dev, n)
    control = runner.reference_steps(base, cfg, dev, n, dtype=torch.bfloat16)
    values = runner.compare_steps(control, ref)
    limits = dict(cfg["check"]["limits"])
    if "check" in traffic:
        r = cfg["render"]
        ck = traffic["check"]
        pix = torch.as_tensor(inputs.sample_pixels(
            SEED, r["width"] * r["height"], ck["pixels"]))
        sc = tracer.make_scene(base["true_inputs"], torch.bfloat16, dev)
        cam = tracer.make_camera(cfg["camera"], r["width"] / r["height"],
                                 torch.bfloat16, dev)
        with torch.no_grad():
            got = tracer.render_pixels(sc, cam, r, base["tkey"], pix,
                                       torch.bfloat16) / r["spp"]
        values["target_mismatch_share"] = ranks.target_mismatch_share(
            got, base, cfg, ck, pix)
        limits["target_mismatch_share"] = \
            ck["limits"]["target_mismatch_share"]
    checks = check.judge(values, limits)
    assert not all(v["ok"] for v in checks.values()), checks
    if "check" in traffic:
        assert not checks["target_mismatch_share"]["ok"], checks


STAND_IN = "scaled"


def _stand_in_reference(monkeypatch) -> None:
    """reference/scaled.py's stand-in, in this process alone: the default
    reference (its own copy of ``train``) with every image its tracer
    renders scaled by faults.ALTER, a frame's and a step's alike."""
    from portbench.reference import tracer

    name = f"portbench.reference.{STAND_IN}"
    spec = importlib.util.spec_from_file_location(
        name, manifest.PB / "reference" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def render_pixels(*args, **kwargs):
        return tracer.render_pixels(*args, **kwargs) * faults.ALTER

    mod.render_pixels = render_pixels
    mod.tracer = types.SimpleNamespace(make_scene=tracer.make_scene,
                                       make_camera=tracer.make_camera,
                                       render_pixels=render_pixels)
    monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if _kind(c) in ("frames", "train_steps")])
def test_named_reference_is_what_the_check_reads(cell, monkeypatch):
    """A sound run fails once its configuration names a reference that
    renders otherwise: the check reads the named module, frames and steps
    alike."""
    _stand_in_reference(monkeypatch)
    out = _run(cell, more={"reference": STAND_IN})
    assert not out["correct"], out["run"].checks


@pytest.mark.parametrize("cell", [c for c in CELLS if _kind(c) == SHARDED])
def test_sharded_target_check_reads_the_named_reference(cell, monkeypatch):
    """The sharded cell's target check (it runs on rank 0, in a process of
    its own, so it is driven here directly) on the port's target: within
    its limit against the configuration's reference, beyond it against a
    named reference that renders otherwise."""
    import torch

    from portbench.harness import inputs, port, ranks

    _stand_in_reference(monkeypatch)
    bench = manifest.load()
    w = manifest.cell(bench, cell)
    cfg = manifest.config(bench, w["config"], OVERRIDES[w["config"]])
    ck = manifest.traffic(w["traffic"])["check"]
    r = cfg["render"]
    dev = torch.device("cpu")
    kept = {"true_inputs": inputs.scene_inputs(cfg["scene"]),
            "tkey": inputs.target_key(SEED)}
    pix = torch.as_tensor(inputs.sample_pixels(
        SEED, r["width"] * r["height"], ck["pixels"]))
    target = port.mean_image(port.build_scene(kept["true_inputs"], cfg, dev),
                             port.build_camera(cfg, dev), cfg, kept["tkey"])
    got = target.reshape(-1, 3).index_select(0, pix)
    limit = ck["limits"]["target_mismatch_share"]
    assert ranks.target_mismatch_share(got, kept, cfg, ck, pix) <= limit
    named = {**cfg, "reference": STAND_IN}
    assert not ranks.target_mismatch_share(got, kept, named, ck, pix) <= limit


def test_named_leaf_limit_holds_the_first_gradient():
    """A limit on one leaf's first-gradient gap is judged like any other:
    camera/translate's passes on a sound run and fails where half of the
    batch is left out of the loss ("altered" reads within the sound seeds'
    spread at this size: LEAF_LIMIT)."""
    cell = next(c for c in CELLS if _kind(c) == "train_steps")
    name = "grad_gap[camera/translate]"
    more = {"check": {"limits": {name: LEAF_LIMIT}}}
    out = _run(cell, more=more)
    assert out["correct"], out["run"].checks
    assert name in out["run"].checks
    undo = faults.plant_train("half_batch")
    try:
        out = _run(cell, more=more)
    finally:
        undo()
    assert not out["run"].checks[name]["ok"], out["run"].checks


def _children() -> list:
    """Processes whose parent is this one, from /proc. The first spawn
    starts multiprocessing's resource tracker, which lives as long as this
    process and is no rank: it is started before the count."""
    resource_tracker.ensure_running()
    out = []
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid():
            out.append(int(stat.parent.name))
    return out


@pytest.mark.parametrize("cell", [c for c in CELLS if _kind(c) == SHARDED])
def test_failed_rank_ends_the_run(cell):
    before = set(_children())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit code"):
        _run(cell, fault=faults.CRASH)
    assert time.monotonic() - t0 < 120
    assert not multiprocessing.active_children()
    assert set(_children()) <= before


@pytest.mark.parametrize("cell", [c for c in CELLS if _kind(c) == SHARDED])
def test_jax_loaded_in_the_check_ends_the_run(cell, capfd):
    """Rank 0 runs the check after the ranks have compared their modules;
    a JAX module that the check loads still ends the run, and rank 0 names
    it on standard error."""
    before = set(_children())
    with pytest.raises(RuntimeError, match="rank 0 of .* exit code"):
        _run(cell, fault=faults.LOADS_JAX)
    assert "rank 0 loaded JAX modules in the check: ['jax']" in \
        capfd.readouterr().err
    assert not multiprocessing.active_children()
    assert set(_children()) <= before


def test_traced_run_reports_layer_metrics_on_cpu():
    out = _run(CELLS[0], trace=True)
    run = out.pop("run")
    assert run.trace_data is not None and run.traced_keys
    line = _run_py().result_line(out, run, "cpu", 1)
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["checks"]


def test_traced_sharded_run_reports_its_step_per_layer():
    cell = next(c for c in CELLS if _kind(c) == SHARDED)
    bench = manifest.load()
    assert "view_step_s" not in {
        m["name"] for m in manifest.e2e_metrics(bench, cell)}
    out = _run(cell, trace=True)
    run = out.pop("run")
    assert out["correct"], run.checks
    step = out["metrics"]["view_step_s.px4"]
    assert step == {"value": run.metrics["view_step_s"], "unit": "s"}
    assert step["value"] > 0


@pytest.mark.cuda
def test_card_run_of_each_cell_is_correct(card):
    import torch

    bench = manifest.load()
    for cell in CELLS:
        if manifest.cell(bench, cell)["chips"] > torch.cuda.device_count():
            continue
        out = runner.run(cell, SEED, 2.0, False, card, time.perf_counter())
        assert out["correct"], out["run"].checks
