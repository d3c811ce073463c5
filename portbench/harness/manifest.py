"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (its "file"), its traffic mix (traffic/<mix>.json), each
per-layer metric (metrics/<metric>.py), each roofline rule
(roofline/<layer>.py), each scene kind (scenes/<kind>.py) and each
configuration's plain reference (reference/<name>.py)."""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import pathlib
import re

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")     # a module's plain name


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def config(bench: dict, name: str, overrides: dict | None = None,
           root: pathlib.Path = ROOT) -> dict:
    """The configuration file of BENCHMARK.json's config `name`, with
    overrides merged in (the CPU tests shrink a cell this way)."""
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = json.loads((root / c["file"]).read_text())
            return _merge(cfg, overrides or {})
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((PB / "traffic" / f"{name}.json").read_text())


def metric_module(name: str):
    """metrics/<name>.py, loaded from its path: a metric's name may hold
    dots, which a module name may not."""
    path = PB / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_rule(layer: str):
    return importlib.import_module(f"portbench.roofline.{layer}")


def scene_kind(kind: str):
    return importlib.import_module(f"portbench.scenes.{kind}")


# The reference of a configuration without a "reference" key: the
# pathwise train step, whose frame interface is the reference tracer's.
DEFAULT_REFERENCE = "train"
FRAME_INTERFACE = ("make_scene", "make_camera", "render_pixels")


def reference(cfg: dict):
    """The plain reference that the configuration's check reads: the module
    reference/<name>.py of its "reference" key (``DEFAULT_REFERENCE``
    without one), holding the frame interface and, for a train
    configuration, ``steps`` (the contract: reference/__init__.py)."""
    name = cfg.get("reference", DEFAULT_REFERENCE)
    path = f"portbench.reference.{name}"
    mod = None
    if NAME.match(name):
        try:
            mod = importlib.import_module(path)
        except ModuleNotFoundError as exc:
            if exc.name != path:
                raise
    if mod is None:
        known = sorted(p.stem for p in (PB / "reference").glob("*.py")
                       if p.stem != "__init__")
        raise KeyError(f"no reference {name!r} under portbench/reference; "
                       f"modules: {known}")
    want = FRAME_INTERFACE + (("steps",) if "train" in cfg else ())
    missing = [f for f in want if not callable(getattr(mod, f, None))]
    if missing:
        raise KeyError(f"reference {name!r} lacks {missing}")
    return mod


def e2e_metrics(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics that cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def layer_metrics(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics that cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in e2e_metrics(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
