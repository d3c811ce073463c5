"""Port of the mesh data model (qt_raytracer_tpu_torch: BVH builders,
build_mesh, MeshBuilder, mesh worlds, world lights, face parameter table,
the mesh kernels' cluster packing and sort keys) against the JAX package.

Everything built on the host is bitwise: the same numpy float64 arithmetic
frozen to float32, with the numpy median builder and, where the native
library builds, the C++ SAH builder. The face area 0.5 |e1 x e2| is within
2 ulps: XLA:CPU may contract the cross product's multiply-subtracts into
FMAs and sum the norm in another order, where the port rounds each op.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu.accel import bvh as jbvh
from qt_raytracer_tpu.accel import mesh as jmesh
from qt_raytracer_tpu.core import world as jworld
from qt_raytracer_tpu.core.scene import SceneBuilder as JSceneBuilder
from qt_raytracer_tpu.kernels import mesh_intersect as jmi
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu.runtime.native_lib import load_native as j_load_native
from qt_raytracer_tpu_torch.accel import bvh as tbvh
from qt_raytracer_tpu_torch.accel import mesh as tmesh
from qt_raytracer_tpu_torch.core import world as tworld
from qt_raytracer_tpu_torch.core.scene import SceneBuilder as TSceneBuilder
from qt_raytracer_tpu_torch.kernels import mesh_intersect as tmi
from qt_raytracer_tpu_torch.models import meshes as tmeshes
from qt_raytracer_tpu_torch.models import scenes as tscenes
from qt_raytracer_tpu_torch.runtime.native_lib import load_native as t_load_native
from qt_raytracer_tpu_torch.utils.convert import mesh_from_arrays, world_from_arrays

WORLDS = {
    "terrain48": (lambda b: jmeshes.terrain_world(48, 48, builder=b),
                  lambda b: tmeshes.terrain_world(48, 48, builder=b,
                                                  device="cpu")),
    "cornell": (lambda b: jmeshes.cornell_box_world(builder=b),
                lambda b: tmeshes.cornell_box_world(builder=b, device="cpu")),
    "icosphere": (lambda b: jmeshes.icosphere_world(2, builder=b),
                  lambda b: tmeshes.icosphere_world(2, builder=b,
                                                    device="cpu")),
}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py: one process
    # that holds too many XLA:CPU executables aborts.
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _builder(name):
    if name == "native" and (j_load_native() is None
                             or t_load_native() is None):
        pytest.skip("the native BVH library does not build here")
    return name


def _assert_fields_equal(got, want: dict):
    for f in dataclasses.fields(got):
        g = getattr(got, f.name).numpy()
        assert g.dtype == want[f.name].dtype, f.name
        np.testing.assert_array_equal(g, want[f.name], err_msg=f.name)


@pytest.mark.parametrize("builder", ["numpy", "native"])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_mesh_worlds_bitwise(name, builder):
    builder = _builder(builder)
    jb, tb = WORLDS[name]
    jw, tw = jb(builder), tb(builder)
    assert tmesh.last_builder == builder
    _assert_fields_equal(tw.mesh, _arrays(jw.mesh))
    _assert_fields_equal(tw.spheres, _arrays(jw.spheres))


def test_numpy_bvh_matches_jax():
    rng = np.random.default_rng(4)
    lo = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, (300, 3)).astype(np.float32)
    want = jbvh.build_bvh(lo, hi, max_leaf=4)
    got = tbvh.build_bvh(lo, hi, max_leaf=4)
    for k in tbvh.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    jbvh.validate_bvh(got, lo, hi)


def test_mesh_builder_materials_bitwise():
    # Per-face materials, the fuzz clamp, emissive faces, a rotated box.
    def fill(b, **kw):
        b.add_triangles([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]],
                        [[0, 1, 2], [1, 3, 2]], mat_type=1,
                        albedo=(0.9, 0.2, 0.1), fuzz=3.0)
        b.add_quad((-1, 2, -1), (2, 0, 0), (0, 0, 2), mat_type=3,
                   emission=(4.0, 5.0, 6.0))
        b.add_box((0.3, 0.5, 0.2), (0.5, 1.0, 0.4), rotate_y=27.0,
                  mat_type=2, ior=1.33)
        return b.build(builder="numpy", **kw)

    want = _arrays(fill(jmesh.MeshBuilder()))
    got = fill(tmesh.MeshBuilder(), device="cpu")
    _assert_fields_equal(got, want)
    assert got.num_triangles == 16 and got.num_lights == 2
    assert float(got.fuzz.max()) == 1.0
    with pytest.raises(ValueError):
        tmesh.MeshBuilder().build(device="cpu")
    with pytest.raises(ValueError, match="builder"):
        tmesh.build_mesh([[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]],
                         builder="sah", device="cpu")


def _mixed_lights_world(pkg):
    """Sphere lights and triangle lights in one world."""
    sb = (JSceneBuilder if pkg == "jax" else TSceneBuilder)()
    sb.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    sb.emissive((0.5, 1.5, 0.0), 0.3, (3.0, 2.0, 1.0))
    sb.emissive((-0.5, 1.5, 0.0), 0.2, (1.0, 2.0, 3.0))
    mb = (jmesh.MeshBuilder if pkg == "jax" else tmesh.MeshBuilder)()
    mb.add_quad((-1, 0, -1), (0, 0, 2), (2, 0, 0))
    mb.add_quad((-0.3, 1.9, -0.3), (0.6, 0, 0), (0, 0, 0.6), mat_type=3,
                emission=(7.0, 7.0, 7.0))
    if pkg == "jax":
        return jworld.World(spheres=sb.build(pad_to=8),
                            mesh=mb.build(builder="numpy"))
    return tworld.World(spheres=sb.build(pad_to=8, device="cpu"),
                        mesh=mb.build(builder="numpy", device="cpu"))


@pytest.mark.parametrize("name", ["cornell", "terrain48", "mixed"])
def test_world_lights_equal(name):
    if name == "mixed":
        jw, tw = _mixed_lights_world("jax"), _mixed_lights_world("torch")
    else:
        jb, tb = WORLDS[name]
        jw, tw = jb("numpy"), tb("numpy")
    want = jworld.world_lights(jw)
    got = tworld.world_lights(tw)
    assert (got.n_sphere, got.n_total) == (want.n_sphere, want.n_total)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.expected_prim.numpy(),
                                  np.asarray(want.expected_prim))
    if name == "mixed":
        assert (got.n_sphere, got.n_total) == (2, 4)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_face_param_table_equal(name):
    jb, tb = WORLDS[name]
    want = np.asarray(jworld.face_param_table(jb("numpy").mesh))
    got = tworld.face_param_table(tb("numpy").mesh).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    cols = [c for c in range(16) if c != 3]
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    ulps = np.abs(got[:, 3] - want[:, 3]) / np.spacing(want[:, 3])
    assert ulps.max() <= 2.0, ulps.max()


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_prep_mesh_clusters_bitwise(name):
    jb, tb = WORLDS[name]
    jm, tm = jb("numpy").mesh, tb("numpy").mesh
    tri, box, _, _, k, k_pad = jmi.prep_mesh_clusters(jm)
    mc = tmi.prep_mesh_clusters(tm)
    assert mc.k == k == tmi.num_clusters(tm.num_triangles)
    assert mc.box_planes.shape == (6, k_pad)
    assert mc.tris_per_cluster == jmi.cluster_rows_for(jm.num_triangles) * 128
    np.testing.assert_array_equal(
        mc.tri_planes.numpy(), np.stack([np.asarray(x).reshape(-1) for x in tri]))
    np.testing.assert_array_equal(
        mc.box_planes.numpy(), np.stack([np.asarray(x).reshape(-1) for x in box]))
    np.testing.assert_array_equal(mc.root_lo.numpy(), np.asarray(jm.bvh_min[0]))
    np.testing.assert_array_equal(mc.root_hi.numpy(), np.asarray(jm.bvh_max[0]))


@pytest.mark.parametrize("num_tris,clusters,rows", [
    (1, 1, 1), (36, 1, 1), (129, 1, 2), (512, 1, 4), (513, 2, 4),
    (4418, 9, 4), (99458, 195, 4)])
def test_cluster_packing_formulas(num_tris, clusters, rows):
    assert tmi.num_clusters(num_tris) == jmi.num_clusters(num_tris) == clusters
    assert tmi.cluster_rows_for(num_tris) == jmi.cluster_rows_for(num_tris) \
        == rows


@pytest.mark.parametrize("name", ["terrain48", "cornell"])
def test_sort_keys_bitwise(name):
    jb, tb = WORLDS[name]
    jm, tm = jb("numpy").mesh, tb("numpy").mesh
    rng = np.random.default_rng(11)
    n = 4096
    lo, hi = np.asarray(jm.bvh_min[0]), np.asarray(jm.bvh_max[0])
    o = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::7, 1] = -0.0                       # signed zeros take octant bit 0
    alive = rng.random(n) < 0.6
    oc = [np.ascontiguousarray(o[:, a]) for a in range(3)]
    dc = [np.ascontiguousarray(d[:, a]) for a in range(3)]
    want = np.asarray(jmi.sort_keys(tuple(map(jnp.asarray, oc)),
                                    tuple(map(jnp.asarray, dc)),
                                    jnp.asarray(alive), jm.bvh_min[0],
                                    jm.bvh_max[0]))
    mc = tmi.prep_mesh_clusters(tm)
    got = tmi.sort_keys(*map(torch.from_numpy, oc + dc),
                        torch.from_numpy(alive), mc.root_lo, mc.root_hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_carry_mesh_and_world_across():
    jw = jmeshes.cornell_box_world(builder="numpy")
    tw = world_from_arrays(_arrays(jw.spheres), _arrays(jw.mesh), device="cpu")
    _assert_fields_equal(tw.mesh, _arrays(jw.mesh))
    _assert_fields_equal(tw.spheres, _arrays(jw.spheres))
    assert torch.equal(mesh_from_arrays(_arrays(jw.mesh),
                                        device="cpu").v0, tw.mesh.v0)
    bare = world_from_arrays(_arrays(jw.spheres), None, device="cpu")
    assert bare.mesh is None and bare.device == torch.device("cpu")
    assert tworld.as_world(bare.spheres).spheres is bare.spheres
    assert tworld.as_world(tw) is tw
    moved = tw.to("meta")
    assert moved.device.type == "meta" and moved.mesh.device.type == "meta"
    with pytest.raises(KeyError):
        mesh_from_arrays({"v0": np.zeros((1, 3), np.float32)}, device="cpu")


@pytest.mark.parametrize("name", ["terrain", "icosphere", "cornell_mesh"])
def test_mesh_scene_cameras_match(name):
    _, jc = jscenes.get_scene(name, 16 / 9, **(
        {"nx": 8, "nz": 8} if name == "terrain" else {}))
    tw, tc = tscenes.get_scene(name, 16 / 9, **(
        {"nx": 8, "nz": 8} if name == "terrain" else {}), device="cpu")
    assert isinstance(tw, tworld.World) and tw.mesh is not None
    want = _arrays(jc)
    for f in dataclasses.fields(tc):
        np.testing.assert_allclose(getattr(tc, f.name).numpy(), want[f.name],
                                   rtol=1e-6, err_msg=f.name)
