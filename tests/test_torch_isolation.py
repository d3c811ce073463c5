"""The port stands apart from JAX, and never hides a missing device or
kernel: importing it loads no JAX; on a machine without CUDA a CUDA render,
the kernel's route and its build raise instead of returning; features not
yet ported raise NotImplementedError naming their ROADMAP item."""

import pathlib
import subprocess
import sys

import pytest
import torch

from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
from qt_raytracer_tpu_torch.kernels import fused_hit as fh
from qt_raytracer_tpu_torch.runtime import cuda_build

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import qt_raytracer_tpu_torch\n"
        "import qt_raytracer_tpu_torch.core.render\n"
        "import qt_raytracer_tpu_torch.utils.convert\n"
        "import qt_raytracer_tpu_torch.runtime.cuda_build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'qt_raytracer_tpu' or "
        "m.startswith('qt_raytracer_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO), "PATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a machine without CUDA")


def _tiny_cfg(**kw):
    return RenderConfig(width=8, height=8, spp=1, max_depth=2, rng="hash",
                        **kw)


def test_cuda_render_raises_without_cuda():
    _no_cuda()
    cfg = _tiny_cfg()
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    with pytest.raises((RuntimeError, AssertionError)):
        render_linear(scene.to("cuda"), cam.to("cuda"), cfg, 0)


def test_render_refuses_mixed_devices():
    cfg = _tiny_cfg()
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    with pytest.raises(ValueError, match="camera"):
        render_linear(scene, cam.to("meta"), cfg, 0)


def _rays(device, n=1024):
    z = lambda: torch.zeros(n, device=device)
    return [z(), z(), z(), z(), z(), torch.ones(n, device=device)], \
        torch.ones(n, dtype=torch.bool, device=device)


def test_kernel_route_raises_instead_of_falling_back():
    _no_cuda()
    scene = scenes.three_sphere_scene()
    # A device that is neither CPU nor CUDA is refused, not run plain.
    tables = fh.prep_fused_spheres(scene.to("meta"))
    rays, alive = _rays("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fh.fused_hit(tables, *rays, alive, 1e-3)
    # The kernel route itself builds or raises: here there is no nvcc.
    tables = fh.prep_fused_spheres(scene)
    rays, alive = _rays("cpu")
    before = fh.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fh._launch(tables, rays, alive, 1e-3)
    assert fh.launches == before


def test_kernel_build_raises_without_nvcc():
    _no_cuda()
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load_library()
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()


def test_library_is_named_after_sources_and_flags():
    path = cuda_build.library_path()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libqtrt_torch_kernels_") and path.suffix == ".so"
    assert path == cuda_build.library_path()
    assert (cuda_build.CSRC_DIR / "fused_hit.cu").is_file()
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


@pytest.mark.parametrize("kw,item", [
    (dict(nee=True), "item 4"),
    (dict(rng="threefry"), "item 6"),
    (dict(edge_aware=True), "item 8"),
    (dict(intersector="xla"), "item 7"),
    (dict(intersector="pallas"), "item 7"),
    (dict(intersector="fused_diff"), "item 7"),
])
def test_unported_features_raise(kw, item):
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1,
                       **{"rng": "hash", **kw})
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio)
    with pytest.raises(NotImplementedError, match=item):
        render_linear(scene, cam, cfg, 0)
