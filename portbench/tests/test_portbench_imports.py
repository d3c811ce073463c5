"""The import rules: a run fails when a JAX module is loaded (top-level
names compared whole), and the reference loads nothing of the port."""

import subprocess
import sys
import types

import pytest

from portbench.harness import env, manifest


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qt_raytracer_tpu_torch_fake",
                        types.ModuleType("qt_raytracer_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert "qt_raytracer_tpu" not in env.forbidden_modules()
    for name in ("jax", "jaxlib.xla", "flax", "qt_raytracer_tpu.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name.split(".")[0] in env.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def _loaded_by(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", sorted(
    p.stem for p in (manifest.PB / "reference").glob("*.py")
    if p.stem != "__init__"))
def test_reference_loads_nothing_of_the_port_or_jax(module):
    tops = _loaded_by(f"import portbench.reference.{module}")
    assert not tops & {"jax", "jaxlib", "flax", "qt_raytracer_tpu",
                       "qt_raytracer_tpu_torch"}


def test_harness_loads_no_jax():
    tops = _loaded_by("import portbench.harness.runner, "
                      "portbench.harness.port, portbench.faults\n"
                      "import qt_raytracer_tpu_torch.diff.inverse")
    assert not tops & {"jax", "jaxlib", "flax", "qt_raytracer_tpu"}


def test_reference_sources_name_no_port():
    for path in (manifest.PB / "reference").glob("*.py"):
        text = path.read_text()
        assert "qt_raytracer_tpu" not in text, path
        assert "import jax" not in text, path


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         manifest.load()["workloads"][0]["name"], "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(manifest.ROOT / ".portbench_cache")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
