"""The port stands apart from JAX, and never hides a missing device or
kernel: importing it loads no JAX; on a machine without CUDA a CUDA render,
the kernel's route and its build raise instead of returning; the features
that raised NotImplementedError until they were ported run."""

import pathlib
import subprocess
import sys

import pytest
import torch

from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
from qt_raytracer_tpu_torch.kernels import fused_hit as fh
from qt_raytracer_tpu_torch.runtime import cuda_build, spans

REPO = pathlib.Path(__file__).resolve().parents[1]
APP_IMPORTS = "".join(
    f"import qt_raytracer_tpu_torch.app.{m}\n"
    for m in ("cli", "progressive", "preview", "interactive", "profiling",
              "stats", "png"))


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import qt_raytracer_tpu_torch\n"
        "import qt_raytracer_tpu_torch.core.render\n"
        "import qt_raytracer_tpu_torch.utils.convert\n"
        "import qt_raytracer_tpu_torch.runtime.cuda_build\n"
        "import qt_raytracer_tpu_torch.kernels.mesh_intersect\n"
        "import qt_raytracer_tpu_torch.kernels.mesh_pairs\n"
        "import qt_raytracer_tpu_torch.core.integrator_flat\n"
        "import qt_raytracer_tpu_torch.core.world\n"
        "import qt_raytracer_tpu_torch.accel.mesh\n"
        "import qt_raytracer_tpu_torch.models.meshes\n"
        "import qt_raytracer_tpu_torch.core.integrator\n"
        "import qt_raytracer_tpu_torch.kernels.sphere_intersect\n"
        "import qt_raytracer_tpu_torch.diff.inverse\n"
        "import qt_raytracer_tpu_torch.diff.multiview\n"
        "import qt_raytracer_tpu_torch.diff.edge\n"
        "import qt_raytracer_tpu_torch.runtime.device\n"
        "import qt_raytracer_tpu_torch.runtime.spans\n"
        "import qt_raytracer_tpu_torch.runtime.native_bvh\n"
        "import qt_raytracer_tpu_torch.accel.traverse\n"
        "import qt_raytracer_tpu_torch.kernels.bvh_walk\n"
        "import qt_raytracer_tpu_torch.kernels.fused_shade\n"
        "import qt_raytracer_tpu_torch.testing.oracle\n"
        "import qt_raytracer_tpu_torch.testing.oracle_vec\n"
        "import qt_raytracer_tpu_torch.parallel.sharding\n"
        "import qt_raytracer_tpu_torch.parallel.distributed\n"
        + APP_IMPORTS +
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'qt_raytracer_tpu' or "
        "m.startswith('qt_raytracer_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO), "PATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_app_loads_no_pil(tmp_path):
    # The app writes PNGs with the standard library alone: the card's
    # machine has no imaging package.
    code = (
        "import sys\n"
        + APP_IMPORTS +
        "import numpy as np\n"
        "from qt_raytracer_tpu_torch.app.png import write_png\n"
        f"write_png({str(tmp_path / 'x.png')!r}, np.zeros((3, 5, 3), np.uint8))\n"
        "bad = sorted(m for m in sys.modules if m == 'PIL' or "
        "m.startswith('PIL.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO), "PATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "x.png").stat().st_size > 0


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour on a machine without CUDA")


def _tiny_cfg(**kw):
    return RenderConfig(width=8, height=8, spp=1, max_depth=2, rng="hash",
                        **kw)


def test_cuda_render_raises_without_cuda():
    _no_cuda()
    cfg = _tiny_cfg()
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        render_linear(scene.to("cuda"), cam.to("cuda"), cfg, 0)


def test_render_refuses_mixed_devices():
    cfg = _tiny_cfg()
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  device="cpu")
    with pytest.raises(ValueError, match="camera"):
        render_linear(scene, cam.to("meta"), cfg, 0)


def _rays(device, n=1024):
    z = lambda: torch.zeros(n, device=device)
    return [z(), z(), z(), z(), z(), torch.ones(n, device=device)], \
        torch.ones(n, dtype=torch.bool, device=device)


def test_kernel_route_raises_instead_of_falling_back():
    _no_cuda()
    scene = scenes.three_sphere_scene(device="cpu")
    # A device that is neither CPU nor CUDA is refused, not run plain.
    tables = fh.prep_fused_spheres(scene.to("meta"))
    rays, alive = _rays("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fh.fused_hit(tables, *rays, alive, 1e-3)
    # The kernel route itself builds or raises: here there is no nvcc.
    tables = fh.prep_fused_spheres(scene)
    rays, alive = _rays("cpu")
    before = spans.counts["fused_hit"]
    with pytest.raises(RuntimeError, match="nvcc"):
        fh._launch(tables, rays, alive, 1e-3)
    assert spans.counts["fused_hit"] == before


@pytest.mark.parametrize("device, interpret, want", [
    ("cpu", False, False),      # a CPU tensor: the plain version
    ("meta", True, False),      # interpret: the plain version, any device
    ("meta", False, None),      # neither CPU nor CUDA: refused
])
def test_use_kernel_route_rule(device, interpret, want):
    dev = torch.empty(0, device=device).device
    if want is None:
        with pytest.raises(ValueError, match="cpu or cuda"):
            cuda_build.use_kernel(dev, interpret, "the kernel")
    else:
        assert cuda_build.use_kernel(dev, interpret, "the kernel") is want


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
    for name in ("fused_hit.cu", "mesh_intersect.cu", "mesh_pairs.cu",
                 "bvh_walk.cu", "fused_shade.cu", "mesh_common.cuh"):
        assert (cuda_build.CSRC_DIR / name).is_file(), name
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_kernel_sources_are_package_data_and_hashed(tmp_path, monkeypatch):
    # Every file under csrc/ ships with the package (pyproject.toml's
    # package-data patterns) and names the library: a shared header that
    # changed must build anew. No source includes a PyTorch header.
    import fnmatch
    import re
    import shutil
    text = (REPO / "pyproject.toml").read_text()
    entry = re.search(r"^qt_raytracer_tpu_torch\s*=\s*\[(.*?)\]", text,
                      re.M | re.S).group(1)
    patterns = re.findall(r'"([^"]+)"', entry)
    files = sorted(f for f in cuda_build.CSRC_DIR.iterdir() if f.is_file())
    assert {f.suffix for f in files} == {".cu", ".cuh"}
    for f in files:
        assert any(fnmatch.fnmatch(f"csrc/{f.name}", pat)
                   for pat in patterns), f.name
        includes = re.findall(r"^#include\s+[<\"]([^>\"]+)", f.read_text(),
                              re.M)
        assert includes and all(
            inc == "cuda_runtime.h" or inc.endswith(".cuh")
            for inc in includes), (f.name, includes)
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, copy)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", copy)
    before = cuda_build.library_path()
    with open(copy / "mesh_common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.library_path() != before


def _edge_cfg():
    return RenderConfig(width=8, height=8, spp=1, max_depth=1, rng="hash",
                        edge_aware=True)


def _runs_edge_aware():
    cfg = _edge_cfg()
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  device="cpu")
    img = render_linear(scene, cam, cfg, 0)
    plain = render_linear(scene, cam, RenderConfig(
        width=8, height=8, spp=1, max_depth=1, rng="hash"), 0)
    assert torch.equal(img, plain)


def _runs_xla():
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2, rng="hash",
                       intersector="xla")
    scene, cam = scenes.get_scene("cornell_mesh", cfg.aspect_ratio,
                                  device="cpu")
    img = render_linear(scene, cam, cfg, 0)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def _rays4():
    return torch.zeros((4, 3)), torch.ones((4, 3))


def _runs_a5_exclude():
    from qt_raytracer_tpu_torch.kernels.sphere_intersect import sphere_search
    t, idx = sphere_search(scenes.three_sphere_scene(device="cpu"), *_rays4(),
                           1e-3,
                           exclude=torch.full((4,), -1, dtype=torch.int32))
    assert t.shape == idx.shape == (4,)


def _big_scene():
    from qt_raytracer_tpu_torch import SceneBuilder
    b = SceneBuilder()
    for k in range(1024):
        b.lambertian((float(k), 0.0, 0.0), 0.1, (0.5, 0.5, 0.5))
    return b.build(pad_to=None, device="cpu")


def _runs_a6_clustered():
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene = _big_scene()
    assert si.prep_sphere_search(scene).num_chunks == 16
    t, idx = si.sphere_search(scene, *_rays4(), 1e-3)
    assert t.shape == idx.shape == (4,)


def _runs_sharded_mesh():
    # A world of one: a mesh without a process group.
    from qt_raytracer_tpu_torch.diff.inverse import adam, make_train_step
    from qt_raytracer_tpu_torch.parallel.sharding import make_mesh
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1, rng="hash")
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  device="cpu")
    init, step, _, _ = make_train_step(scene, cam, cfg, adam(1e-2),
                                       mesh=make_mesh())
    _, loss = step(init(), torch.zeros((8, 8, 3)), 0)
    assert bool(torch.isfinite(loss))


def _runs_exclude_prim0():
    from qt_raytracer_tpu_torch.core.integrator import trace
    out = trace(scenes.three_sphere_scene(device="cpu"), *_rays4(),
                torch.zeros(4, dtype=torch.int64), 1,
                exclude_prim0=torch.full((4,), -1, dtype=torch.int32))
    assert out.shape == (4, 3)


def _keys4():
    return torch.zeros(4, dtype=torch.int64)


def _runs_compact():
    from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat
    scene = scenes.three_sphere_scene(device="cpu")
    assert torch.equal(trace_flat(scene, *_rays4(), _keys4(), 2, compact=True),
                       trace_flat(scene, *_rays4(), _keys4(), 2))


def _mesh_clusters():
    from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
    from qt_raytracer_tpu_torch.models import meshes
    world = meshes.icosphere_world(1, builder="numpy", device="cpu")
    return mi, mi.prep_mesh_clusters(world.mesh)


def _flat4():
    return [torch.zeros(4)] * 3 + [torch.ones(4)] * 3


def _runs_pair_first_cluster():
    mi, mc = _mesh_clusters()
    c1, c2 = mi.first_crossed_cluster(mc, *_flat4(), 1e-3, pair=True)
    assert c1.shape == c2.shape == (4,)


def _mesh_search_runs(**kw):
    from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
    from qt_raytracer_tpu_torch.models import meshes
    world = meshes.icosphere_world(1, builder="numpy", device="cpu")
    mc = mi.prep_mesh_clusters(world.mesh, mt="mxu")   # with every table
    t, idx = mi.mesh_search(mc, *_flat4(), 1e-3, **kw)
    assert t.shape == idx.shape == (4,)


def _runs_rowgate():
    _mesh_search_runs(visit="rowgate")


def _runs_subtile():
    _mesh_search_runs(visit="subtile")


def _runs_sliced():
    _mesh_search_runs(visit="sliced")


def _runs_mxu():
    _mesh_search_runs(mt="mxu")


def _runs_pairs_kernel():
    from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat_world
    from qt_raytracer_tpu_torch.models import meshes
    world = meshes.icosphere_world(1, builder="numpy", device="cpu")
    want = trace_flat_world(world, *_rays4(), _keys4(), 2)
    for kernel in ("pairs", "hybrid"):
        assert torch.equal(trace_flat_world(world, *_rays4(), _keys4(), 2,
                                            mesh_kernel=kernel), want)


def _runs_sort_modes():
    mi, mc = _mesh_clusters()
    for mode in ("crossing2", "morton"):
        t, idx = mi.mesh_search(mc, *_flat4(), 1e-3, sort_mode=mode)
        assert t.shape == idx.shape == (4,)


# What raised NotImplementedError until it was ported.
@pytest.mark.parametrize("run", [_runs_edge_aware, _runs_a5_exclude,
                                 _runs_a6_clustered, _runs_exclude_prim0,
                                 _runs_compact, _runs_pair_first_cluster,
                                 _runs_pairs_kernel, _runs_sort_modes,
                                 _runs_rowgate, _runs_subtile, _runs_sliced,
                                 _runs_mxu, _runs_xla, _runs_sharded_mesh])
def test_ported_features_run(run):
    run()


def test_exclude_refusals_are_the_jax_packages():
    # The two places where an exclude operand raises ValueError, as in JAX:
    # the clustered sphere sweep, and trace_flat with compact=True.
    from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat
    from qt_raytracer_tpu_torch.kernels.sphere_intersect import sphere_search
    none = torch.full((4,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="clustered"):
        sphere_search(_big_scene(), *_rays4(), 1e-3, exclude=none)
    with pytest.raises(ValueError, match="compact"):
        trace_flat(scenes.three_sphere_scene(device="cpu"), *_rays4(),
                   _keys4(), 1, compact=True, exclude_prim0=none)
    # So an edge-aware render of a scene of 1,024 slots through "pallas"
    # raises, in the port as in JAX.
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1, rng="hash",
                       edge_aware=True, intersector="pallas")
    cam = scenes.three_sphere_camera(cfg.aspect_ratio, device="cpu")
    with pytest.raises(ValueError, match="clustered"):
        render_linear(_big_scene(), cam, cfg, 0)
