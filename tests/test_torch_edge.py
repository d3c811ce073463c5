"""Edge-aware gradients of the port (qt_raytracer_tpu_torch.diff.edge) on
the CPU, through the plain versions of the kernels with their exclude
operands, against the JAX package with its Pallas kernels in interpret mode,
and against central finite differences of the port's own fixed-key render.

Both branches of ``sample_radiance_edge_aware`` are held against JAX: the
fused branch (``fused_diff_interpret`` on the sphere Cornell box) and the
general branch (``pallas_interpret`` on the true Cornell box, a mesh world),
at 24x16, spp 2, depth 2, with and without NEE, on an L2 loss against a
constant image.

Tolerances. The forward image of an edge-aware render equals the plain
render bit for bit (the term is primal zero). Gradients against jax.grad:
within 2e-3 |ref| + 2e-3 max|ref| (XLA:CPU contracts multiply-adds that
PyTorch rounds one by one, and the sum over pixels runs in another order).
Against finite differences the bands are those of the JAX package's own
tests (tests/test_edge_gradients.py, tests/test_mesh_edge_gradients.py): the
estimator is a Monte-Carlo edge sampler with an O(W) kernel bias, so it
matches FD within 15% to a factor of two depending on the functional.

The JAX package reads its kernel order and shadow switch from the
environment when it traces ``diff/edge.py``; the cases that set them use a
frame size of their own, so no compiled graph of another case is reused and
no cache is dropped in mid-module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qt_raytracer_tpu import RenderConfig as JConfig
from qt_raytracer_tpu.core.camera import make_camera as j_make_camera
from qt_raytracer_tpu.core.scene import SceneBuilder as JSceneBuilder
from qt_raytracer_tpu.diff.inverse import image_loss as j_image_loss
from qt_raytracer_tpu.models import meshes as jmeshes
from qt_raytracer_tpu.models import scenes as jscenes
from qt_raytracer_tpu_torch import RenderConfig as TConfig
from qt_raytracer_tpu_torch.accel.mesh import MeshBuilder
from qt_raytracer_tpu_torch.core.camera import make_camera
from qt_raytracer_tpu_torch.core.scene import SceneBuilder
from qt_raytracer_tpu_torch.core.world import World
from qt_raytracer_tpu_torch.diff.inverse import image_loss, mean_image
from qt_raytracer_tpu_torch.utils.convert import (camera_from_arrays,
                                                  scene_from_arrays,
                                                  world_from_arrays)
from torch_helpers import _one_thread  # noqa: F401

SIZE = dict(width=24, height=16, spp=2, max_depth=2, rng="hash")
TARGET_LEVEL = 0.3


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # Module-start cache drop, as in tests/test_kernels.py (ROADMAP.md).
    jax.clear_caches()
    # Start PyTorch's CPU thread pool before XLA's: a pool first started
    # after XLA has run was seen to take its first vectorised sqrt a few
    # 1e-5 off in one thread, which the expanded-form roots amplify.
    torch.sqrt(torch.rand(2048, 512)).sum()
    yield


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, aspect):
    if name == "cornell_mesh":
        js = jmeshes.cornell_box_world(builder="numpy")
        jc = jmeshes.cornell_box_mesh_camera(aspect)
        ts = world_from_arrays(_arrays(js.spheres), _arrays(js.mesh),
                               device="cpu")
    elif name == "lit_ball":
        # Floor, ball and emitter under a sky (tests/test_multiview.py's
        # scene): no r = 1000 walls, whose r^2 - rho^2 cancels badly.
        js = JSceneBuilder() \
            .lambertian((0.0, -100.5, -1.0), 100.0, (0.6, 0.6, 0.6)) \
            .lambertian((0.0, 0.0, -1.5), 0.5, (0.75, 0.25, 0.2)) \
            .emissive((0.0, 1.6, -1.5), 0.4, (9.0, 9.0, 9.0)).build(pad_to=8)
        jc = j_make_camera(lookfrom=(0.0, 0.4, 1.2), lookat=(0.0, 0.0, -1.5),
                           vup=(0, 1, 0), vfov=55.0, aspect_ratio=aspect,
                           aperture=0.0, focus_dist=1.0)
        ts = scene_from_arrays(_arrays(js), device="cpu")
    else:
        js, jc = jscenes.get_scene(name, aspect, pad_to=8)
        ts = scene_from_arrays(_arrays(js), device="cpu")
    return (js, jc), (ts, camera_from_arrays(_arrays(jc), device="cpu"))


def _rebuild(scene, cam, p):
    """The scene and camera with the parameters p put in: "radius" and
    "center" of the spheres, "v0" of the mesh, "translate" of the camera."""
    is_world = hasattr(scene, "mesh")
    sph = scene.spheres if is_world else scene
    sph = dataclasses.replace(sph, **{k: p[k] for k in ("radius", "center")
                                      if k in p})
    if is_world:
        mesh = scene.mesh
        if "v0" in p:
            mesh = dataclasses.replace(mesh, v0=p["v0"])
        scene = dataclasses.replace(scene, spheres=sph, mesh=mesh)
    else:
        scene = sph
    if "translate" in p:
        cam = dataclasses.replace(
            cam, origin=cam.origin + p["translate"],
            lower_left_corner=cam.lower_left_corner + p["translate"])
    return scene, cam


def _init(scene, field):
    if field == "translate":
        return np.zeros(3, np.float32)
    if field == "v0":
        return np.asarray(scene.mesh.v0)
    sph = scene.spheres if hasattr(scene, "mesh") else scene
    return np.asarray(getattr(sph, field))


def _jax_and_port(name, intersector, fields, size=SIZE, **cfg_kw):
    """((loss, grads) of JAX, (loss, grads) of the port, plain render
    equals edge-aware render in the port) for an edge-aware L2 loss."""
    kw = dict(size, intersector=intersector, edge_aware=True)
    nee = cfg_kw.pop("nee", True)
    jcfg = JConfig(nee=nee, **kw)
    tcfg = TConfig(nee=nee, **kw, **cfg_kw)
    (js, jc), (ts, tc) = _both(name, jcfg.aspect_ratio)
    target = np.full((jcfg.height, jcfg.width, 3), TARGET_LEVEL, np.float32)

    jp = {f: jnp.asarray(_init(js, f)) for f in fields}
    jl, jg = jax.value_and_grad(lambda p: j_image_loss(
        *_rebuild(js, jc, p), jcfg, jax.random.PRNGKey(0),
        jnp.asarray(target)))(jp)

    tp = {f: torch.tensor(_init(js, f), requires_grad=True) for f in fields}
    tl = image_loss(*_rebuild(ts, tc, tp), tcfg, 0,
                    torch.from_numpy(target))
    tg = torch.autograd.grad(tl, list(tp.values()))
    with torch.no_grad():
        plain = mean_image(ts, tc, dataclasses.replace(
            tcfg, edge_aware=False), 0)
        edge = mean_image(ts, tc, tcfg, 0)
    return ((float(jl), {f: np.asarray(jg[f]) for f in fields}),
            (float(tl.detach()), {f: g.numpy() for f, g in zip(fields, tg)}),
            torch.equal(plain, edge))


def _assert_grads_match(j, t):
    (jl, jg), (tl, tg) = j, t
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for f, want in jg.items():
        assert np.isfinite(tg[f]).all(), f
        assert np.abs(want).max() > 0, f
        np.testing.assert_allclose(tg[f], want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max(),
                                   err_msg=f)


CASES = {
    # fused branch: trace_flat(diff=True), A1 for the winner, A1 with the
    # exclude operand for the background, A5 for the shadow block
    "fused_nee": ("cornell", "fused_diff_interpret",
                  ("radius", "center", "translate"), dict(nee=True)),
    "fused_no_nee": ("cornell", "fused_diff_interpret",
                     ("radius", "center", "translate"), dict(nee=False)),
    # general branch: three searches through intersect_world, A5 and A3
    # with their exclude operands
    "mesh_nee": ("cornell_mesh", "pallas_interpret",
                 ("translate", "v0", "radius", "center"), dict(nee=True)),
    "mesh_no_nee": ("cornell_mesh", "pallas_interpret",
                    ("translate", "v0"), dict(nee=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_aware_gradients_match_jax(case):
    name, intersector, fields, kw = CASES[case]
    j, t, primal_zero = _jax_and_port(name, intersector, fields, **kw)
    assert primal_zero
    _assert_grads_match(j, t)


def _port_only(name, intersector, fields, size, **cfg_kw):
    """{field: gradient} of the port's edge-aware L2 loss with NEE."""
    tcfg = TConfig(nee=True, intersector=intersector, edge_aware=True,
                   **size, **cfg_kw)
    (js, _), (ts, tc) = _both(name, tcfg.aspect_ratio)
    target = torch.full((tcfg.height, tcfg.width, 3), TARGET_LEVEL)
    tp = {f: torch.tensor(_init(js, f), requires_grad=True) for f in fields}
    tl = image_loss(*_rebuild(ts, tc, tp), tcfg, 0, target)
    tg = torch.autograd.grad(tl, list(tp.values()))
    return {f: g.numpy() for f, g in zip(fields, tg)}


def _differs(a, b, frac):
    return np.abs(a - b).max() > frac * np.abs(a).max()


def test_order_two_weight_and_shadow_switch_match_jax(monkeypatch):
    # The Richardson-extrapolated weight 2 w_{W/2} - w_W at half a pixel,
    # without the shadow-edge term: cfg.edge_kernel_order, edge_kernel_px
    # and edge_shadow here, the environment in the JAX package (read when it
    # traces, so this frame size is its own). On the floor, ball and
    # emitter scene: at W = 0.5 the order-2 weight is 32 times as steep as
    # the default, and on the Cornell box's r = 1000 walls, whose
    # r^2 - rho^2 cancels to an ulp of 1e6, that slope turns the two
    # packages' rounding into percents of the gradient.
    monkeypatch.setenv("QTRT_EDGE_KERNEL_ORDER", "2")
    monkeypatch.setenv("QTRT_EDGE_KERNEL_PX", "0.5")
    monkeypatch.setenv("QTRT_EDGE_SHADOW", "0")
    size = dict(SIZE, width=26)
    fields = ("radius", "translate")
    opts = dict(edge_kernel_order=2, edge_kernel_px=0.5, edge_shadow=False)
    j, t, primal_zero = _jax_and_port("lit_ball", "fused_diff_interpret",
                                      fields, size=size, **opts)
    assert primal_zero
    _assert_grads_match(j, t)
    # Each option changes the gradient of this frame.
    for k, default in (("edge_kernel_order", 1), ("edge_kernel_px", 1.0),
                       ("edge_shadow", True)):
        other = _port_only("lit_ball", "fused_diff_interpret", fields, size,
                           **dict(opts, **{k: default}))
        assert _differs(other["translate"], t[1]["translate"], 1e-4), k


def test_edge_shadow_off_removes_the_shadow_term():
    # edge_shadow=False drops the NEE shadow-edge term and leaves the
    # silhouette term alone (tests/test_shadow_edge.py): on the mesh world
    # the gradient with the term is another one, and without NEE, where the
    # term does not exist, the switch changes nothing, bit for bit.
    size = dict(SIZE, width=22)
    fields = ("translate", "v0")
    on = _port_only("cornell_mesh", "pallas_interpret", fields, size)
    off = _port_only("cornell_mesh", "pallas_interpret", fields, size,
                     edge_shadow=False)
    assert _differs(on["translate"], off["translate"], 1e-3)
    assert _differs(on["v0"], off["v0"], 1e-3)

    def no_nee(shadow):
        cfg = TConfig(nee=False, intersector="pallas_interpret",
                      edge_aware=True, edge_shadow=shadow, **size)
        (_, _), (ts, tc) = _both("cornell_mesh", cfg.aspect_ratio)
        tr = torch.zeros(3, requires_grad=True)
        loss = image_loss(*_rebuild(ts, tc, {"translate": tr}), cfg, 0,
                          torch.full((cfg.height, cfg.width, 3), 0.3))
        return torch.autograd.grad(loss, tr)[0]

    assert torch.equal(no_nee(True), no_nee(False))


def test_edge_options_are_validated():
    with pytest.raises(ValueError, match="edge_kernel_order"):
        TConfig(edge_kernel_order=3)
    with pytest.raises(ValueError, match="edge_kernel_px"):
        TConfig(edge_kernel_px=0.0)
    cfg = TConfig(edge_aware=True, spp=8, samples_per_batch=4)
    assert cfg.samples_per_batch == 1
    assert (cfg.edge_kernel_px, cfg.edge_kernel_order, cfg.edge_shadow) \
        == (1.0, 1, True)


# ------------------------------------------------ finite differences
FD_CFG = TConfig(width=64, height=48, spp=16, max_depth=2,
                 intersector="fused_diff")
FD_CFG_EDGE = dataclasses.replace(FD_CFG, edge_aware=True)


def _one_sphere():
    """One Lambertian sphere against the sky, fully inside the frame: the
    mean radiance is dominated by the visibility boundary
    (tests/test_edge_gradients.py)."""
    scene = SceneBuilder().lambertian((0.0, 0.0, -3.0), 1.0,
                                      (0.8, 0.2, 0.2)) \
        .build(pad_to=8, device="cpu")
    cam = make_camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
                      vfov=60.0, aspect_ratio=FD_CFG.aspect_ratio,
                      aperture=0.0, focus_dist=1.0, device="cpu")
    return scene, cam


def _fd_and_grads(loss, eps):
    """(central difference of the plain render, gradient of the plain
    render, gradient of the edge-aware render) of loss(x, cfg) at x = 0."""
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps), FD_CFG))
              - float(loss(torch.tensor(-eps), FD_CFG))) / (2 * eps)
    out = []
    for cfg in (FD_CFG, FD_CFG_EDGE):
        x = torch.zeros((), requires_grad=True)
        val = loss(x, cfg)
        # A render that x does not reach has no graph: its gradient is 0.
        g = torch.autograd.grad(val, x)[0] if val.requires_grad else 0.0
        out.append(float(g))
    return fd, out[0], out[1]


def _shift(cam, delta):
    return dataclasses.replace(cam, origin=cam.origin + delta,
                               lower_left_corner=cam.lower_left_corner
                               + delta)


def _unit(k):
    return torch.eye(3)[k]


def test_radius_silhouette_gradient_matches_fd():
    # The radius moves the silhouette almost purely. The pathwise gradient
    # sees next to nothing; the edge-aware one matches FD within 15%.
    scene, cam = _one_sphere()
    pick = torch.zeros_like(scene.radius)
    pick[0] = 1.0

    def loss(dr, cfg):
        sc = dataclasses.replace(scene, radius=scene.radius + dr * pick)
        return mean_image(sc, cam, cfg, 0).mean()

    fd, g_plain, g_edge = _fd_and_grads(loss, 2e-2)
    assert abs(g_plain) < 0.1 * abs(fd), (g_plain, fd)
    np.testing.assert_allclose(g_edge, fd, rtol=0.15)


def test_camera_translation_silhouette_gradient():
    scene, cam = _one_sphere()
    loss = lambda dx, cfg: mean_image(scene, _shift(cam, dx * _unit(0)), cfg,
                                      0).mean()
    fd, g_plain, g_edge = _fd_and_grads(loss, 4e-2)
    assert np.sign(g_edge) == np.sign(fd) and abs(g_edge) > 5 * abs(g_plain)
    np.testing.assert_allclose(g_edge, fd, rtol=1.0)


def test_center_gradient_through_squared_loss():
    scene, cam = _one_sphere()
    with torch.no_grad():
        target = mean_image(scene, cam, FD_CFG, 0)
    pick = torch.zeros_like(scene.center)
    pick[0, 0] = 1.0

    def loss(dcx, cfg):
        sc = dataclasses.replace(scene,
                                 center=scene.center + (0.3 + dcx) * pick)
        return ((mean_image(sc, cam, cfg, 0) - target) ** 2).mean()

    fd, _, g_edge = _fd_and_grads(loss, 2e-2)
    assert np.sign(g_edge) == np.sign(fd)
    np.testing.assert_allclose(g_edge, fd, rtol=0.5)


def _quad_world():
    """One diffuse quad facing the camera in front of the sky, with a far
    dummy sphere (tests/test_mesh_edge_gradients.py)."""
    m = MeshBuilder()
    m.add_quad((-0.7, -0.5, -3.0), (1.4, 0.0, 0.0), (0.0, 1.0, 0.0),
               albedo=(0.8, 0.3, 0.2))
    b = SceneBuilder()
    b.lambertian((0.0, -500.0, 0.0), 1.0, (0.5, 0.5, 0.5))
    return World(spheres=b.build(pad_to=8, device="cpu"),
                 mesh=m.build(builder="numpy", device="cpu"))


def test_camera_translation_mesh_l2_gradient_matches_fd():
    # The general branch on a mesh world: camera translation through the L2
    # loss. The pathwise gradient is 0 here (a diffuse quad's radiance does
    # not depend on the viewpoint); the triangle edge margin carries it.
    world, cam = _quad_world(), _one_sphere()[1]
    with torch.no_grad():
        target = mean_image(world, cam, FD_CFG, 0)

    def loss(dx, cfg):
        img = mean_image(world, _shift(cam, (0.10 + dx) * _unit(0)), cfg, 0)
        return ((img - target) ** 2).mean()

    fd, g_plain, g_edge = _fd_and_grads(loss, 2e-2)
    assert abs(fd) > 1e-3, fd
    assert np.sign(g_edge) == np.sign(fd)
    assert abs(g_edge) > 0.25 * abs(fd), (g_edge, fd)
    assert abs(g_plain) < 0.05 * abs(fd), (g_plain, fd)
    np.testing.assert_allclose(g_edge, fd, rtol=1.0)


def test_mesh_translation_gradient_matches_fd():
    # A rigid z-translation of the quad changes its projected size; the
    # gradient flows through the v0/e1/e2 gathers of the triangle margin.
    world, cam = _quad_world(), _one_sphere()[1]

    def loss(dz, cfg):
        delta = dz * _unit(2)
        mesh = dataclasses.replace(world.mesh, v0=world.mesh.v0 + delta,
                                   bvh_min=world.mesh.bvh_min + delta,
                                   bvh_max=world.mesh.bvh_max + delta)
        return mean_image(dataclasses.replace(world, mesh=mesh), cam, cfg,
                          0).mean()

    fd, g_plain, g_edge = _fd_and_grads(loss, 4e-2)
    assert np.sign(g_edge) == np.sign(fd) and abs(g_edge) > 5 * abs(g_plain)
    np.testing.assert_allclose(g_edge, fd, rtol=0.3)
