"""The port's gradient path on the CPU, through the plain versions of
kernels A2, A3 and A5, against the JAX package with its Pallas kernels in
interpret mode: Hits of intersect_spheres / intersect_world, radiance of
the [N,3] integrator (`pallas`) and of trace_flat(diff=True)
(`fused_diff`), gradients against jax.grad, and gradients against central
finite differences of the port's own fixed-key render (the settings of
tests/test_gradients.py: eps 1e-2, rtol 5e-2).

Tolerances. Renders: at most 1% of channels beyond 2e-3 + 2e-3 |ref| (the
flip budget of tests/test_torch_render.py: a ray that grazes an edge can
take another branch on an ulp). Hits: the same winner on 99.9% of rays; on
those, t, point and normal within 1e-4 + 1e-4 |ref| (XLA:CPU contracts
multiply-adds that PyTorch rounds one by one). Gradients: within
2e-3 |ref| + 2e-3 max|ref| of jax.grad, for the same reasons and because
the sum over pixels runs in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu import render_linear as j_render_linear
from qt_raytracer_tpu.core.intersect import intersect_spheres as j_isect
from qt_raytracer_tpu.core.world import intersect_world as j_isect_world
from qt_raytracer_tpu.diff.inverse import image_loss as j_image_loss
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch import render_linear as t_render_linear
from qt_raytracer_tpu_torch.core.camera import make_camera
from qt_raytracer_tpu_torch.core.intersect import intersect_spheres
from qt_raytracer_tpu_torch.core.scene import SceneBuilder
from qt_raytracer_tpu_torch.core.world import intersect_world
from qt_raytracer_tpu_torch.diff.inverse import (image_loss, mean_image,
                                                 split_scene)
from qt_raytracer_tpu_torch.runtime import spans
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  scene_from_arrays,
                                                  world_from_arrays)
from torch_helpers import _one_thread  # noqa: F401

ATOL = RTOL = 2e-3
MAX_MISMATCH = 0.01
SIZE = dict(width=16, height=12, spp=2, max_depth=4)


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, aspect):
    """(JAX scene, JAX camera), (port scene, port camera)."""
    if name == "cornell_mesh":
        js = jmeshes.cornell_box_world(builder="numpy")
        jc = jmeshes.cornell_box_mesh_camera(aspect)
        ts = world_from_arrays(_arrays(js.spheres), _arrays(js.mesh),
                               device="cpu")
    else:
        js, jc = jscenes.get_scene(name, aspect)
        ts = scene_from_arrays(_arrays(js), device="cpu")
    return (js, jc), (ts, camera_from_arrays(_arrays(jc), device="cpu"))


def _mismatch(got, want):
    return np.abs(got - want) > ATOL + RTOL * np.abs(want)


def _random_rays(n, seed, lo=-1.5, hi=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 1.9, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) >= 0.1
    return o, d, alive


@pytest.mark.parametrize("name", ["cornell", "random", "cornell_mesh"])
def test_hits_match_jax(name):
    (js, _), (ts, _) = _both(name, 1.0)
    o, d, alive = _random_rays(1000, seed=len(name))
    jargs = (jnp.asarray(o), jnp.asarray(d), 1e-3)
    targs = (torch.from_numpy(o), torch.from_numpy(d), 1e-3)
    if name == "cornell_mesh":
        want = j_isect_world(js, *jargs, backend="pallas_interpret",
                             alive=jnp.asarray(alive))
        got = intersect_world(ts, *targs, alive=torch.from_numpy(alive))
    else:
        want = j_isect(js, *jargs, backend="pallas_interpret",
                       alive=jnp.asarray(alive))
        got = intersect_spheres(ts, *targs, alive=torch.from_numpy(alive))
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    live = alive
    np.testing.assert_array_equal(got["hit"][live], want["hit"][live])
    same = live & (got["prim_idx"] == want["prim_idx"])
    assert same.sum() >= 0.999 * live.sum()
    hit = same & want["hit"]
    assert hit.mean() > 0.5
    for k in ("mat_type", "front_face"):
        np.testing.assert_array_equal(got[k][hit], want[k][hit])
    for k in ("t", "point", "normal", "albedo", "emission", "radius", "area"):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


TRACE_CASES = {
    "three_sphere_hash": ("three_sphere", "hash", "pallas_interpret", False),
    "three_sphere_threefry": ("three_sphere", "threefry", "pallas_interpret",
                              False),
    "cornell_mesh_nee": ("cornell_mesh", "hash", "pallas_interpret", True),
    "cornell_fused_diff_nee": ("cornell", "hash", "fused_diff_interpret",
                               True),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_gradient_path_radiance_matches_jax(case):
    name, rng, intersector, nee = TRACE_CASES[case]
    kw = dict(SIZE, rng=rng, nee=nee, intersector=intersector)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    (js, jc), (ts, tc) = _both(name, jcfg.aspect_ratio)
    want = np.asarray(j_render_linear(js, jc, jcfg, jax.random.PRNGKey(3)))
    got = t_render_linear(ts, tc, tcfg, 3)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((want > 0).mean()) > 0.3
    mismatch = _mismatch(got.numpy(), want)
    assert mismatch.mean() <= MAX_MISMATCH, mismatch.mean()


def _jax_and_port_grads(name, intersector, nee, fields):
    """Gradients of the L2 loss against a fixed target, in both packages,
    with respect to scene fields (or "translate": a camera translation, or
    "v0": the mesh's first vertices)."""
    kw = dict(SIZE, rng="hash", nee=nee, intersector=intersector)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    (js, jc), (ts, tc) = _both(name, jcfg.aspect_ratio)
    target = np.asarray(j_render_linear(js, jc, jcfg,
                                        jax.random.PRNGKey(9))) / jcfg.spp

    def j_rebuild(p):
        sc, cam = js, jc
        if "translate" in p:
            cam = dataclasses.replace(
                jc, origin=jc.origin + p["translate"],
                lower_left_corner=jc.lower_left_corner + p["translate"])
        if "v0" in p:
            sc = dataclasses.replace(js, mesh=dataclasses.replace(
                js.mesh, v0=p["v0"]))
        rest = {k: v for k, v in p.items() if k not in ("translate", "v0")}
        return dataclasses.replace(sc, **rest) if rest else sc, cam

    def t_rebuild(p):
        sc, cam = ts, tc
        if "translate" in p:
            cam = dataclasses.replace(
                tc, origin=tc.origin + p["translate"],
                lower_left_corner=tc.lower_left_corner + p["translate"])
        if "v0" in p:
            sc = dataclasses.replace(ts, mesh=dataclasses.replace(
                ts.mesh, v0=p["v0"]))
        rest = {k: v for k, v in p.items() if k not in ("translate", "v0")}
        return dataclasses.replace(sc, **rest) if rest else sc, cam

    def init(f, pkg):
        if f == "translate":
            return np.zeros(3, np.float32)
        src = (js if pkg == "j" else ts)
        if f == "v0":
            return np.asarray(src.mesh.v0)
        return np.asarray(getattr(src, f))

    jp = {f: jnp.asarray(init(f, "j")) for f in fields}
    jg = jax.grad(lambda p: j_image_loss(*j_rebuild(p), jcfg,
                                         jax.random.PRNGKey(0),
                                         jnp.asarray(target)))(jp)
    tp = {f: torch.tensor(init(f, "t"), requires_grad=True) for f in fields}
    loss = image_loss(*t_rebuild(tp), tcfg, 0, torch.from_numpy(target))
    tg = torch.autograd.grad(loss, list(tp.values()))
    return {f: np.asarray(jg[f]) for f in fields}, dict(zip(fields, tg))


GRAD_CASES = {
    "three_sphere_albedo": ("three_sphere", "pallas_interpret", False,
                            ("albedo",)),
    "cornell_fused_diff_nee": ("cornell", "fused_diff_interpret", True,
                               ("albedo", "emission")),
    "cornell_camera": ("cornell", "pallas_interpret", True, ("translate",)),
    "cornell_mesh_vertices": ("cornell_mesh", "pallas_interpret", True,
                              ("v0", "translate")),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_match_jax(case):
    jg, tg = _jax_and_port_grads(*GRAD_CASES[case])
    for f, want in jg.items():
        got = tg[f].numpy()
        assert np.isfinite(got).all()
        assert np.abs(want).max() > 0, f
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max(),
                                   err_msg=f)


def _fd_check(loss_fn, x0: torch.Tensor, eps, rtol, atol=1e-4,
              max_checks=6):
    """torch.autograd against central differences on the largest
    coordinates of the gradient."""
    x = x0.clone().requires_grad_(True)
    g = torch.autograd.grad(loss_fn(x), x)[0].numpy().ravel()
    base = x0.double().numpy().ravel()
    for i in np.argsort(-np.abs(g))[:max_checks]:
        step = np.zeros_like(base)
        step[i] = eps
        val = lambda v: float(loss_fn(torch.tensor(
            v.reshape(x0.shape), dtype=torch.float32)))
        fd = (val(base + step) - val(base - step)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=rtol, atol=atol)


def test_albedo_gradient_matches_fd():
    cfg = TConfig(width=12, height=8, spp=2, max_depth=3, rng="hash",
                  intersector="pallas")
    (_, _), (scene, cam) = _both("three_sphere", cfg.aspect_ratio)
    with torch.no_grad():
        target = mean_image(scene, cam, cfg, 9)
    loss = lambda a: image_loss(dataclasses.replace(scene, albedo=a), cam,
                                cfg, 0, target)
    _fd_check(loss, scene.albedo, eps=1e-2, rtol=5e-2)


def test_emission_gradient_matches_fd():
    cfg = TConfig(width=8, height=8, spp=2, max_depth=3, rng="hash",
                  nee=True, intersector="fused_diff")
    (_, _), (scene, cam) = _both("cornell", 1.0)
    with torch.no_grad():
        target = mean_image(scene, cam, cfg, 9)
    loss = lambda e: image_loss(dataclasses.replace(scene, emission=e), cam,
                                cfg, 0, target)
    _fd_check(loss, scene.emission, eps=1e-2, rtol=5e-2)


def test_camera_origin_gradient_matches_fd():
    # A sphere that fills the frame: no hit/miss flips within eps, so FD of
    # the fixed-key render is the pathwise gradient (tests/test_gradients.py).
    cfg = TConfig(width=12, height=8, spp=2, max_depth=3, rng="hash",
                  intersector="pallas")
    scene = SceneBuilder().lambertian((0.0, 0.0, -5.0), 3.0,
                                      (0.6, 0.4, 0.3)).build(pad_to=None,
                                                             device="cpu")
    cam = make_camera((0, 0, 0), (0, 0, -5.0), vfov=20.0,
                      aspect_ratio=cfg.aspect_ratio, aperture=0.0,
                      focus_dist=5.0, device="cpu")
    with torch.no_grad():
        target = mean_image(scene, cam, cfg, 9)

    def loss(origin):
        c2 = dataclasses.replace(
            cam, origin=origin,
            lower_left_corner=cam.lower_left_corner + (origin - cam.origin))
        return image_loss(scene, c2, cfg, 0, target)

    _fd_check(loss, cam.origin, eps=2e-3, rtol=5e-2, atol=5e-4)


@pytest.mark.parametrize("intersector", ["fused_diff", "pallas"])
def test_gradients_finite_everywhere(intersector):
    # Metal and dielectric paths: safe_sqrt and safe_unit_vector guards.
    cfg = TConfig(width=12, height=8, spp=2, max_depth=3, rng="hash",
                  intersector=intersector)
    (_, _), (scene, cam) = _both("glossy_dof", cfg.aspect_ratio)
    with torch.no_grad():
        target = mean_image(scene, cam, cfg, 9)
    params, rebuild = split_scene(scene, ("albedo", "emission", "fuzz",
                                          "center", "radius", "ior"))
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(image_loss(rebuild(params), cam, cfg, 0,
                                           target), list(params.values()))
    for name, g in zip(params, grads):
        assert bool(torch.isfinite(g).all()), name
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_forward_only_paths_raise_in_backward():
    # "fused" (and a mesh world's forward path) render tensors that require
    # grad, and refuse to differentiate.
    for name, intersector in (("three_sphere", "fused"),
                              ("cornell_mesh", "fused")):
        cfg = TConfig(width=8, height=8, spp=1, max_depth=2, rng="hash",
                      intersector=intersector)
        (_, _), (scene, cam) = _both(name, 1.0)
        sc = scene.spheres if name == "cornell_mesh" else scene
        a = sc.albedo.clone().requires_grad_(True)
        sc = dataclasses.replace(sc, albedo=a)
        scene = dataclasses.replace(scene, spheres=sc) \
            if name == "cornell_mesh" else sc
        img = t_render_linear(scene, cam, cfg, 0)
        assert img.requires_grad and bool(torch.isfinite(img).all())
        with pytest.raises(ValueError, match="grad_capable_config"):
            img.sum().backward()


def test_kernel_counts_stay_zero_on_the_cpu():
    cfg = TConfig(width=8, height=8, spp=1, max_depth=2, rng="hash",
                  intersector="pallas", nee=True)
    (_, _), (world, cam) = _both("cornell_mesh", 1.0)
    before = spans.counts["sphere_search"]
    img = t_render_linear(world, cam, cfg, 0)
    assert spans.counts["sphere_search"] == before
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("rows,cols", [(9, 16), (5, 3)])
def test_gather_rows_matches_index_gradient(rows, cols):
    # gather_rows' backward sums each row's gradients (index_add_): against
    # the float64 sums, on skewed ids as a wavefront's winners are; a float32
    # sum of up to 4,096 unit normals in any order is within 1e-4.
    from qt_raytracer_tpu_torch.core.vecmath import gather_rows
    rng = np.random.default_rng(rows)
    table = torch.tensor(rng.normal(size=(rows, cols)).astype(np.float32),
                         requires_grad=True)
    idx = torch.tensor(np.minimum(rng.geometric(0.5, 4096) - 1, rows - 1),
                       dtype=torch.int32)
    g = torch.tensor(rng.normal(size=(4096, cols)).astype(np.float32))
    out = gather_rows(table, idx)
    assert torch.equal(out, table.detach()[idx.long()])
    got, = torch.autograd.grad(out, table, g)
    want = torch.zeros((rows, cols), dtype=torch.float64).index_add_(
        0, idx.long(), g.double())
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)
    with torch.no_grad():
        assert not gather_rows(table, idx).requires_grad
