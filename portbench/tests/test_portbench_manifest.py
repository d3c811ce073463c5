"""BENCHMARK.json against the benchmark's contract and its files: every
cell's configuration, traffic mix, metric and plain reference is a file of
its own, found by name, and run.py names no cell."""

import json
import re

import pytest

from portbench.harness import manifest, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_entries_have_their_keys(bench, kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}[kind]
    for e in bench[kind]:
        assert set(e) == keys
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_cells_find_their_files(bench):
    for w in bench["workloads"]:
        cfg = manifest.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        traffic = manifest.traffic(w["traffic"])
        assert traffic["kind"] in runner.DRIVERS
        assert w["chips"] in (1, 4)
        if "ranks" in traffic:
            mesh = traffic["mesh"]
            assert traffic["ranks"] == w["chips"] == mesh["sp"] * mesh["px"]


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", [m["name"]
                                    for m in manifest.load()["per_layer"]])
def test_metric_file_declares_its_entry(bench, metric):
    entry = next(m for m in bench["per_layer"] if m["name"] == metric)
    mod = manifest.metric_module(metric)
    assert mod.LAYER == entry["layer"]
    assert mod.UNIT == entry["unit"]
    assert mod.MOVES == entry["moves"]
    assert tuple(mod.WORKLOADS) == tuple(entry["workloads"])
    assert callable(mod.read)


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.e2e_metrics(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.layer_metrics(bench, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("layer", ["sphere_hit", "mesh"])
def test_roofline_rules_found_by_name(layer):
    rule = manifest.roofline_rule(layer)
    assert rule.KERNELS and rule.STRIDE >= 1 and callable(rule.bound_s)


def test_run_py_names_no_cell(bench):
    text = (manifest.PB / "run.py").read_text()
    for w in bench["workloads"]:
        assert w["name"] not in text
    for c in bench["configs"]:
        assert c["name"] not in text
    for path in (manifest.PB / "harness").glob("*.py"):
        body = path.read_text()
        for w in bench["workloads"]:
            assert w["name"] not in body, path


@pytest.mark.parametrize("config", [c["name"]
                                    for c in manifest.load()["configs"]])
def test_config_without_a_reference_key_reads_tracer_and_train(bench,
                                                               config):
    from portbench.reference import tracer, train

    cfg = manifest.config(bench, config)
    assert "reference" not in cfg
    plain = manifest.reference(cfg)
    for name in manifest.FRAME_INTERFACE:
        assert getattr(plain, name) is getattr(tracer, name)
    if "train" in cfg:
        assert plain.steps is train.steps


def test_unknown_reference_raises_naming_the_modules():
    with pytest.raises(KeyError, match=r"no reference 'nope'.*"
                       r"\['rng', 'tracer', 'train'"):
        manifest.reference({"reference": "nope"})
    with pytest.raises(KeyError, match="no reference '../tracer'"):
        manifest.reference({"reference": "../tracer"})
    # A module that lacks the interface its configuration needs.
    with pytest.raises(KeyError, match=r"'rng' lacks \['make_scene'"):
        manifest.reference({"reference": "rng"})
    with pytest.raises(KeyError, match=r"'tracer' lacks \['steps'\]"):
        manifest.reference({"reference": "tracer", "train": {}})
