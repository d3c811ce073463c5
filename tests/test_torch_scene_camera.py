"""Port of the data model (qt_raytracer_tpu_torch: scenes, packed parameter
tables, cameras, RenderConfig, pixel chunking) against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.core import camera as jcam
from qt_raytracer_tpu.core import config as jconfig
from qt_raytracer_tpu.core import render as jrender
from qt_raytracer_tpu.core.intersect import packed_param_table as j_ptab
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch.core import camera as tcam
from qt_raytracer_tpu_torch.core import config as tconfig
from qt_raytracer_tpu_torch.core import render as trender
from qt_raytracer_tpu_torch.core.integrator_flat import trace_flat_world
from qt_raytracer_tpu_torch.core.intersect import packed_param_table as t_ptab
from qt_raytracer_tpu_torch.core.world import World
from qt_raytracer_tpu_torch.kernels.mesh_intersect import mesh_search, prep_mesh_clusters
from qt_raytracer_tpu_torch.models import scenes as tscenes
from qt_raytracer_tpu_torch.utils.convert import camera_from_arrays, scene_from_arrays

SPHERE_SCENES = ["three_sphere", "four_sphere_gpu", "random", "glossy_dof",
                 "cornell"]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (CLAUDE.md).
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_scenes_and_param_tables_bitwise(name):
    js, _ = jscenes.get_scene(name, 16 / 9)
    ts, _ = tscenes.get_scene(name, 16 / 9, device="cpu")
    want = _arrays(js)
    for f in dataclasses.fields(ts):
        got = getattr(ts, f.name).numpy()
        assert got.dtype == want[f.name].dtype, f.name
        np.testing.assert_array_equal(got, want[f.name], err_msg=f.name)
    np.testing.assert_array_equal(t_ptab(ts).numpy(), np.asarray(j_ptab(js)))
    # Carrying the JAX scene across gives the same tensors.
    carried = scene_from_arrays(want, device="cpu")
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(carried, f.name), getattr(ts, f.name))


def test_random_scene_padding_and_morton_order():
    ts = tscenes.random_scene(device="cpu")
    assert ts.num_spheres == 512 and int(ts.active.sum()) == 487
    assert torch.all(ts.center[~ts.active] == 1.0e9)
    assert ts.num_lights == 0
    cornell = tscenes.cornell_box_spheres(device="cpu")
    assert cornell.light_idx.tolist() == [5]


@pytest.mark.parametrize("name", SPHERE_SCENES)
@pytest.mark.parametrize("aspect", [16 / 9, 1.0])
def test_make_camera_matches(name, aspect):
    _, jc = jscenes.get_scene(name, aspect)
    _, tc = tscenes.get_scene(name, aspect, device="cpu")
    want = _arrays(jc)
    for f in dataclasses.fields(tc):
        np.testing.assert_allclose(getattr(tc, f.name).numpy(), want[f.name],
                                   rtol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("name", ["random", "glossy_dof"])
def test_get_rays_on_identical_inputs(name):
    _, jc = jscenes.get_scene(name, 16 / 9)
    tc = camera_from_arrays(_arrays(jc), device="cpu")
    rng = np.random.default_rng(5)
    s, t, u1, u2 = rng.random((4, 4096), dtype=np.float32)
    jo, jd = jcam.get_rays(jc, *map(jnp.asarray, (s, t, u1, u2)))
    to, td = tcam.get_rays(tc, *map(torch.from_numpy, (s, t, u1, u2)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    {},
    dict(width=0, height=-5, spp=0, max_depth=0),
    dict(width=999999, height=999999, spp=5000, max_depth=1000),
    dict(spp=10, samples_per_batch=4),
    dict(spp=7, samples_per_batch=3),
    dict(edge_aware=True, samples_per_batch=4),
    dict(width=1920, height=1080, spp=1, rng="hash", quantizer="gpu"),
])
def test_render_config_clamps_match(kw):
    j = jconfig.RenderConfig(**kw)
    t = tconfig.RenderConfig(**kw)
    want, got = dataclasses.asdict(j), dataclasses.asdict(t)
    # The port's own fields: the edge and mesh-search options that the JAX
    # package reads from the environment, at its defaults.
    own = {k: got.pop(k) for k in sorted(set(got) - set(want))}
    assert own == {"edge_kernel_order": 1, "edge_kernel_px": 1.0,
                   "edge_shadow": True, "mesh_cluster_rows": 4,
                   "mesh_compact": False, "mesh_kernel": "clustered",
                   "mesh_mt": "vpu", "mesh_pair_c": 6, "mesh_sort0": True,
                   "mesh_sort_mode": "crossing", "mesh_sort_pipe": "gather",
                   "mesh_visit": "full"}
    assert got == want
    assert t.num_pixels == j.num_pixels and t.aspect_ratio == j.aspect_ratio


@pytest.mark.parametrize("kw", [dict(quantizer="x"), dict(rng="x"),
                                dict(intersector="x"), dict(pixel_chunk=-2)])
def test_render_config_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        jconfig.RenderConfig(**kw)
    with pytest.raises(ValueError):
        tconfig.RenderConfig(**kw)


@pytest.mark.parametrize("wh,chunk", [
    ((1920, 1080, 0), 414720), ((3840, 2160, 0), None), ((1280, 720, 0), None),
    ((640, 360, 0), None), ((400, 225, 0), None), ((512, 512, 0), None),
    ((1920, 1080, -1), None), ((32, 32, 512), None), ((1000, 1000, 0), None),
])
def test_resolve_pixel_chunk_matches(wh, chunk):
    w, h, pc = wh
    kw = dict(width=w, height=h, pixel_chunk=pc)
    got = trender.resolve_pixel_chunk(tconfig.RenderConfig(**kw))
    assert got == jrender.resolve_pixel_chunk(jconfig.RenderConfig(**kw))
    if chunk is not None:
        assert got == chunk


def test_pixel_grid_matches():
    cfg_kw = dict(width=37, height=19)
    ji, jj, jp = jrender.pixel_grid(jconfig.RenderConfig(**cfg_kw))
    ti, tj, tp = trender.pixel_grid(tconfig.RenderConfig(**cfg_kw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))


def test_mesh_scene_not_ported():
    # Mesh scenes are ported: a World and its camera, with compaction, the
    # pair-wavefront kernels, the row gate and the bilinear-form engine. A
    # search whose factors the clusters were built without raises.
    world, cam = tscenes.get_scene("cornell_mesh", 16 / 9, device="cpu")
    assert isinstance(world, World) and world.mesh is not None
    assert world.mesh.num_triangles == 36 and world.mesh.num_lights == 2
    rays = torch.zeros((4, 3)), torch.ones((4, 3))
    keys = torch.zeros(4, dtype=torch.int64)
    plain = trace_flat_world(world, *rays, keys, 1)
    assert torch.equal(trace_flat_world(world, *rays, keys, 1, compact=True),
                       plain)
    assert torch.equal(trace_flat_world(world, *rays, keys, 1,
                                        mesh_kernel="pairs"), plain)
    flat = (*rays[0].T.contiguous(), *rays[1].T.contiguous())
    mc = prep_mesh_clusters(world.mesh)
    with pytest.raises(ValueError, match="mt_planes"):
        mesh_search(mc, *flat, 1e-3, mt="mxu")
    full = prep_mesh_clusters(world.mesh, mt="mxu")
    want = mesh_search(mc, *flat, 1e-3)
    for tables, kw in ((full, dict(mt="mxu")), (mc, dict(visit="rowgate"))):
        got = mesh_search(tables, *flat, 1e-3, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw
    with pytest.raises(KeyError):
        tscenes.get_scene("nope", 16 / 9, device="cpu")


def test_constructors_build_on_the_card_unless_asked_for_the_cpu():
    # device=None is the CUDA card: without one every constructor raises,
    # naming the missing CUDA, instead of building on the CPU in silence;
    # device="cpu" gives CPU tensors.
    from qt_raytracer_tpu_torch.accel.mesh import build_mesh
    from qt_raytracer_tpu_torch.core.scene import SceneBuilder
    from qt_raytracer_tpu_torch.core.world import tensors_of
    from qt_raytracer_tpu_torch.models import meshes as tmeshes
    from qt_raytracer_tpu_torch.runtime.device import resolve_device
    from qt_raytracer_tpu_torch.utils import convert

    tri = ([[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]])
    ball = lambda: SceneBuilder().lambertian((0, 0, -1), 0.5, (0.5,) * 3)
    scene, cam = tscenes.get_scene("three_sphere", 1.5, device="cpu")
    arrays = {k: np.asarray(v) for k, v in
              zip((f.name for f in dataclasses.fields(scene)),
                  tensors_of(scene))}
    makers = {
        "get_scene": lambda **kw: tscenes.get_scene("cornell", 1.5, **kw),
        "scene": lambda **kw: tscenes.random_scene(**kw),
        "camera": lambda **kw: tscenes.random_scene_camera(1.5, **kw),
        "make_camera": lambda **kw: tcam.make_camera((0, 0, 1), (0, 0, 0),
                                                     **kw),
        "SceneBuilder": lambda **kw: ball().build(**kw),
        "build_mesh": lambda **kw: build_mesh(*tri, builder="numpy", **kw),
        "mesh_world": lambda **kw: tmeshes.icosphere_world(
            1, builder="numpy", **kw),
        "mesh_camera": lambda **kw: tmeshes.icosphere_camera(1.5, **kw),
        "scene_from_arrays": lambda **kw: scene_from_arrays(arrays, **kw),
        "world_from_arrays": lambda **kw: convert.world_from_arrays(
            arrays, None, **kw),
    }
    for name, build in makers.items():
        out = build(device="cpu")
        for obj in out if isinstance(out, tuple) else (out,):
            assert all(t.device.type == "cpu" for t in tensors_of(obj)), name
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build()
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in tensors_of(ball().build()))
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
