"""The CUDA kernels on the card against their plain PyTorch versions, at
shapes the main paths do not reach: ray counts that are not a multiple of
the thread block, sphere counts below, between and above the 256-sphere
shared-memory tile, blocks with no live ray, a multi-cluster terrain and the
one-cluster Cornell mesh, finite per-lane caps that prune, the wavefront
sort on and off; and small renders on the card against the same renders on
the CPU.

Needs a CUDA card (marker ``cuda``) and skips without one. This module
imports no JAX, so it runs on a machine without it; ``tests/conftest.py``
does import JAX, so run it there with
``python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py``.

Tolerances: the kernels round op by op as the plain versions do. Full mode
(A1): winner ids agree on every live lane and the refined t within rtol
1e-5, the other float outputs within atol 1e-5 + rtol 1e-5 (the limits of
``chip_smoke.py``); dead lanes hold the defaults exactly. Shadow mode (A2),
the first crossed cluster (A4) and the mesh search (A3): bitwise on live
lanes, BIG/0 (A4: k) on dead lanes (A4 and the crossing lists of A7 also
against their two-level gate's walk, on the gate's edge rays of
``tests/test_torch_cluster_gate.py``); the sphere search (A5) and the
cluster-culled sphere search (A6) likewise. The exclude operand of A1, A2,
A3 and A5 is held the same way, each ray excluding its own winner. A3's
row-gated and bilinear-form instances equal their plain versions on every
lane; the row gate, smaller clusters and the slice visits equal A3's
default on live lanes, and the bilinear form agrees with it on 99.9% of
live lanes (its candidates round otherwise). The bilinear form's block
kernel (A3m: packed tiles, a TF32 filter, the exact re-test) is also held
bitwise on tied copies and on ``torch_helpers.mxu_adversarial``, at t_min
1e-3, 0 and -0.5, wherever its rays land in the blocks. The BVH walk of
``intersector="xla"`` equals its plain version bitwise on live lanes, with
alive, exclude and a finite t_max, on the card and against the CPU; the
[N, S] sphere search gives the same bits under the global TF32 switch.
The shading kernel (``shade_kernel``) equals the PyTorch route of
``integrator_flat._shade`` bit for bit on every output and lane, NaN and
inf included, and a frame rendered with it equals the frame rendered
without it bit for bit. Renders: at most 1% of channels beyond 2e-3 +
2e-3 |ref|, as in ``tests/test_torch_render.py``; render gradients within
2e-3 of the largest entry, the flip budget of a few rays.
"""

import numpy as np
import pytest
import torch

from qt_raytracer_tpu_torch import RenderConfig, SceneBuilder, render_linear, scenes
from qt_raytracer_tpu_torch.kernels import fused_hit as fh
from qt_raytracer_tpu_torch.core import integrator_flat as itf
from qt_raytracer_tpu_torch.kernels import mesh_intersect as mi
from qt_raytracer_tpu_torch.models import meshes
from qt_raytracer_tpu_torch.runtime import spans
from test_torch_cluster_gate import WORLDS as GATE_WORLDS
from torch_helpers import mxu_adversarial, shade_inputs, with_copies

pytestmark = pytest.mark.cuda

T_MIN = 1e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts(*names) -> tuple:
    """The launch counts under names, in order."""
    return tuple(spans.counts[k] for k in names)


def _scene(num_spheres: int, seed: int):
    """Ground plus num_spheres - 1 random spheres of every material, unpadded
    (S = num_spheres) so the kernel sees S as given. Built on the CPU; the
    tests move a copy to the card and keep the CPU one to compare with."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for _ in range(num_spheres - 1):
        c = (rng.uniform(-6, 6), rng.uniform(0.1, 2.0), rng.uniform(-6, 6))
        r = rng.uniform(0.05, 0.6)
        m = rng.integers(0, 3)
        if m == 0:
            b.lambertian(c, r, rng.random(3))
        elif m == 1:
            b.metal(c, r, rng.random(3), rng.random())
        else:
            b.dielectric(c, r, 1.5)
    return b.build(pad_to=None, device="cpu")


def _rays(n: int, seed: int, device):
    """n random rays above the ground; a fully dead 256-ray block where n
    allows, and about 10% scattered dead lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.01, 3.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) >= 0.1
    if n >= 512:
        alive[256:512] = False
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, k])).to(device)
             for x in (o, d) for k in range(3)]
    return comps, torch.from_numpy(alive).to(device)


def _assert_hits_agree(kern: dict, plain: dict, alive: torch.Tensor):
    kern = {k: v.cpu() for k, v in kern.items()}
    plain = {k: v.cpu() for k, v in plain.items()}
    alive = alive.cpu()
    assert torch.equal(kern["idx"][alive], plain["idx"][alive])
    for k in ("mat", "ff"):
        assert torch.equal(kern[k][alive], plain[k][alive]), k
    hit = alive & (plain["t"] < fh.BIG)
    for k in fh.FLOAT_NAMES:
        lanes = hit if k == "t" else alive
        a, b = kern[k][lanes].double(), plain[k][lanes].double()
        atol = 0.0 if k == "t" else 1e-5
        assert torch.all((a - b).abs() <= atol + 1e-5 * b.abs()), k
    dead = ~alive
    for k in fh.NAMES:
        assert torch.equal(kern[k][dead], plain[k][dead]), k


@pytest.mark.parametrize("num_spheres", [4, 128, 300, 640])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_kernel_matches_plain_version(card, n, num_spheres):
    tables = fh.prep_fused_spheres(_scene(num_spheres, seed=num_spheres).to(card))
    rays, alive = _rays(n, seed=n, device=card)
    before = spans.counts["fused_hit"]
    kern = fh.fused_hit(tables, *rays, alive, T_MIN)
    assert spans.counts["fused_hit"] == before + 1
    plain = fh.fused_hit(tables, *rays, alive, T_MIN, interpret=True)
    assert spans.counts["fused_hit"] == before + 1   # the plain one counts 0
    torch.cuda.synchronize()
    assert all(v.device == card for v in kern.values())
    _assert_hits_agree(kern, plain, alive)


def test_all_dead_rays_get_defaults(card):
    tables = fh.prep_fused_spheres(_scene(300, seed=1).to(card))
    rays, alive = _rays(777, seed=2, device=card)
    dead = torch.zeros_like(alive)
    out = fh.fused_hit(tables, *rays, dead, T_MIN)
    defaults = dict(zip(fh.FLOAT_NAMES, fh.FLOAT_DEFAULTS))
    defaults.update(zip(fh.INT_NAMES, fh.INT_DEFAULTS))
    for k, v in defaults.items():
        assert torch.all(out[k].cpu() == v), k


def test_wrapper_refuses_mixed_devices(card):
    tables = fh.prep_fused_spheres(_scene(4, seed=0))        # on the CPU
    rays, alive = _rays(64, seed=0, device=card)
    with pytest.raises(ValueError, match="tables"):
        fh.fused_hit(tables, *rays, alive, T_MIN)


@pytest.mark.parametrize("name", ["three_sphere", "glossy_dof", "cornell"])
def test_render_on_card_matches_cpu(card, name):
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=5, rng="hash",
                       pixel_chunk=512)
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio, device="cpu")
    spans.counts.clear()
    got = render_linear(scene.to(card), cam.to(card), cfg, 5)
    # 3 chunks of 512
    assert spans.counts["fused_hit"] == 3 * cfg.spp * cfg.max_depth
    assert got.device == card and bool(torch.isfinite(got).all())
    want = render_linear(scene, cam, cfg, 5)
    bad = (got.cpu() - want).abs() > 2e-3 + 2e-3 * want.abs()
    assert float(bad.float().mean()) <= 0.01


@pytest.mark.parametrize("num_spheres", [4, 300])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_shadow_kernel_matches_plain_version(card, n, num_spheres):
    tables = fh.prep_fused_spheres(_scene(num_spheres, seed=num_spheres).to(card))
    rays, alive = _rays(n, seed=n + 7, device=card)
    before = _counts("fused_hit", "fused_hit_shadow")
    kern = fh.fused_hit(tables, *rays, alive, T_MIN, shadow_only=True)
    assert _counts("fused_hit", "fused_hit_shadow") == (before[0],
                                                         before[1] + 1)
    plain = fh.fused_hit(tables, *rays, alive, T_MIN, shadow_only=True,
                         interpret=True)
    assert spans.counts["fused_hit_shadow"] == before[1] + 1
    torch.cuda.synchronize()
    assert sorted(kern) == ["idx", "t"]
    alive = alive.cpu()
    for k in ("t", "idx"):
        a, b = kern[k].cpu(), plain[k].cpu()
        assert torch.equal(a[alive], b[alive]), k
    assert torch.all(kern["t"].cpu()[~alive] == fh.BIG)
    assert torch.all(kern["idx"].cpu()[~alive] == 0)


@pytest.fixture(scope="module")
def mesh_worlds(card):
    """A 9-cluster terrain and the one-cluster Cornell mesh, on the card."""
    worlds = {"terrain48": meshes.terrain_world(48, 48, device="cpu"),
              "cornell_mesh": meshes.cornell_box_world(device="cpu")}
    return {k: mi.prep_mesh_clusters(w.mesh.to(card)) for k, w in worlds.items()}


def _mesh_rays(mc, n: int, seed: int, device):
    """n rays from around the mesh's root box, 60% alive; half the lanes
    capped at a distance inside the box, the rest at BIG."""
    rng = np.random.default_rng(seed)
    lo, hi = mc.root_lo.cpu().numpy(), mc.root_hi.cpu().numpy()
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.6
    cap = np.where(rng.random(n) < 0.5, rng.uniform(0.2, 2.0, n),
                   fh.BIG).astype(np.float32)
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, k])).to(device)
             for x in (o, d) for k in range(3)]
    return (comps, torch.from_numpy(alive).to(device),
            torch.from_numpy(cap).to(device))


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh"])
def test_mesh_kernels_match_plain_versions(card, mesh_worlds, name, n, capped):
    mc = mesh_worlds[name]
    rays, alive, cap = _mesh_rays(mc, n, seed=n, device=card)
    cap = cap if capped else None
    before = _counts("mesh_first_cluster", "mesh_search")
    c1 = mi.first_crossed_cluster(mc, *rays, T_MIN, alive, cap)
    assert spans.counts["mesh_first_cluster"] == before[0] + 1
    c1_plain = mi.first_crossed_cluster(mc, *rays, T_MIN, alive, cap,
                                        interpret=True)
    assert torch.equal(c1.cpu(), c1_plain.cpu())
    assert torch.all(c1.cpu()[~alive.cpu()] == mc.k)

    plain = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                           interpret=True)
    live = alive.cpu()
    for sort in (False, True):
        got = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                             sort=sort)
        for a, b in zip(got, plain):
            assert torch.equal(a.cpu()[live], b.cpu()[live]), sort
        assert torch.all(got[0].cpu()[~live] == fh.BIG)
        assert torch.all(got[1].cpu()[~live] == 0)
    sorted_run = n >= mi.SORT_MIN_RAYS and mc.k > 1
    assert spans.counts["mesh_search"] == before[1] + 2
    assert spans.counts["mesh_first_cluster"] == before[0] + 1 + sorted_run
    if capped and n >= 1000:
        # The finite caps prune hits that the uncapped search finds.
        free = mi.mesh_search(mc, *rays, T_MIN, alive=alive, interpret=True)
        assert bool(((free[0] < fh.BIG) & (plain[0] >= fh.BIG)).any())


@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh"])
def test_mesh_kernels_all_dead(card, mesh_worlds, name):
    mc = mesh_worlds[name]
    rays, alive, cap = _mesh_rays(mc, 4097, seed=3, device=card)
    dead = torch.zeros_like(alive)
    t, idx = mi.mesh_search(mc, *rays, T_MIN, alive=dead, t_cap=cap)
    assert torch.all(t.cpu() == fh.BIG) and torch.all(idx.cpu() == 0)
    c1 = mi.first_crossed_cluster(mc, *rays, T_MIN, dead, cap)
    assert torch.all(c1.cpu() == mc.k)


@pytest.mark.parametrize("name", ["cornell_mesh_nee", "terrain48"])
def test_world_render_on_card_matches_cpu(card, name):
    if name == "terrain48":
        world = meshes.terrain_world(48, 48, device="cpu")
        cfg = RenderConfig(width=48, height=48, spp=2, max_depth=5,
                           rng="hash", pixel_chunk=-1)
        cam = meshes.terrain_camera(cfg.aspect_ratio, device="cpu")
        # One chunk of 2,304 rays: the A4 sort runs at every bounce.
        want_counts = (10, 0, 10, 10)
    else:
        world = meshes.cornell_box_world(device="cpu")
        cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5,
                           nee=True, rng="hash", pixel_chunk=512)
        cam = meshes.cornell_box_mesh_camera(cfg.aspect_ratio,
                                             device="cpu")
        # 2 chunks x 2 samples x 5 bounces; two mesh searches per bounce,
        # one cluster, so no sort.
        want_counts = (20, 20, 0, 40)
    spans.counts.clear()
    got = render_linear(world.to(card), cam.to(card), cfg, 5)
    assert _counts("fused_hit", "fused_hit_shadow", "mesh_first_cluster",
                   "mesh_search") == want_counts
    assert got.device == card and bool(torch.isfinite(got).all())
    want = render_linear(world, cam, cfg, 5)
    bad = (got.cpu() - want).abs() > 2e-3 + 2e-3 * want.abs()
    assert float(bad.float().mean()) <= 0.01


# ------------------------------------------- sphere search (A5), gradients
@pytest.mark.parametrize("num_spheres", [4, 64, 300, 960])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_sphere_search_kernel_matches_plain_version(card, n, num_spheres):
    # 960 spheres are 15 chunks, the largest table of the monolithic sweep
    # (16 chunks take the clustered one); 4 and 300 leave padding slots.
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene = _scene(num_spheres, seed=num_spheres + 1).to(card)
    comps, alive = _rays(n, seed=n + 11, device=card)
    o = torch.stack(comps[:3], dim=1)
    d = torch.stack(comps[3:], dim=1)
    before = spans.counts["sphere_search"]
    kern = si.sphere_search(scene, o, d, T_MIN, alive=alive)
    assert spans.counts["sphere_search"] == before + 1
    plain = si.sphere_search(scene, o, d, T_MIN, alive=alive, interpret=True)
    assert spans.counts["sphere_search"] == before + 1   # the plain: 0
    torch.cuda.synchronize()
    alive = alive.cpu()
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu()[alive], b.cpu()[alive])
    assert torch.all(kern[0].cpu()[~alive] == si.BIG)
    assert torch.all(kern[1].cpu()[~alive] == 0)
    assert bool((kern[1] < num_spheres).all())


@pytest.mark.parametrize("name,intersector", [
    ("cornell", "fused_diff"), ("cornell", "pallas"),
    ("cornell_mesh", "pallas")])
def test_gradients_on_card_match_cpu(card, name, intersector):
    # Loss and scene/camera gradients of a small NEE render on the card
    # against the same render on the CPU (plain versions): within 2e-3
    # relative of the largest entry, the flip budget of a few rays.
    import dataclasses
    from qt_raytracer_tpu_torch.core import sampling
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    cfg = RenderConfig(width=24, height=16, spp=2, max_depth=4, rng="hash",
                       nee=True, intersector=intersector)
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio, device="cpu")

    def grads(device):
        sc, c = scene.to(device), cam.to(device)
        spheres = sc.spheres if name == "cornell_mesh" else sc
        alb = spheres.albedo.clone().requires_grad_(True)
        tr = torch.zeros(3, device=device, requires_grad=True)
        spheres = dataclasses.replace(spheres, albedo=alb)
        sc = dataclasses.replace(sc, spheres=spheres) \
            if name == "cornell_mesh" else spheres
        c = dataclasses.replace(c, origin=c.origin + tr,
                                lower_left_corner=c.lower_left_corner + tr)
        img = render_linear(sc, c, cfg, sampling.prng_key(3))
        loss = (img ** 2).mean()
        return [x.cpu() for x in (loss, *torch.autograd.grad(loss,
                                                             [alb, tr]))]

    spans.counts.clear()
    on_card = grads(card)
    counts = _counts("sphere_search", "fused_hit_shadow")
    assert counts[0] > 0 if intersector == "pallas" else counts[1] > 0
    on_cpu = grads("cpu")
    for a, b in zip(on_card, on_cpu):
        assert bool(torch.isfinite(a).all())
        assert torch.allclose(a, b, rtol=2e-3,
                              atol=2e-3 * float(b.abs().max()))


def test_gather_rows_backward_on_card_is_exact(card):
    # vecmath.gather_rows sums each row's gradients with index_add_ (atomic
    # adds on the card). With integer-valued gradients every partial sum is
    # exact in float32, so any order gives the exact per-row sums.
    from qt_raytracer_tpu_torch.core.vecmath import gather_rows
    rng = np.random.default_rng(3)
    n, rows = 414720, 9
    idx = torch.tensor(np.minimum(rng.geometric(0.3, n) - 1, rows - 1))
    g = torch.tensor(rng.integers(-8, 9, (n, 16)).astype(np.float32))
    table = torch.zeros((rows, 16), device=card, requires_grad=True)
    out = gather_rows(table, idx.to(card))
    got, = torch.autograd.grad(out, table, g.to(card))
    want = torch.zeros((rows, 16), dtype=torch.float64).index_add_(
        0, idx, g.double())
    assert torch.equal(got.cpu().double(), want)


# ------------------------- exclude operands (A1, A2, A3, A5) and A6
def _own_winner(idx, t, alive):
    """Each live hitting lane's own winner as its exclude id; -1 on every
    third lane and where there is no hit."""
    excl = torch.where(alive & (t < fh.BIG), idx, -1).to(torch.int32)
    excl[::3] = -1
    return excl


@pytest.mark.parametrize("num_spheres", [4, 300, 640])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_fused_hit_exclude_matches_plain_version(card, n, num_spheres):
    tables = fh.prep_fused_spheres(
        _scene(num_spheres, seed=num_spheres).to(card))
    rays, alive = _rays(n, seed=n + 3, device=card)
    first = fh.fused_hit(tables, *rays, alive, T_MIN, shadow_only=True)
    excl = _own_winner(first["idx"], first["t"], alive)
    before = _counts("fused_hit", "fused_hit_shadow")
    kern = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=excl)
    plain = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=excl,
                         interpret=True)
    shadow = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=excl,
                          shadow_only=True)
    shadow_plain = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=excl,
                                shadow_only=True, interpret=True)
    assert _counts("fused_hit", "fused_hit_shadow") == (before[0] + 1,
                                                         before[1] + 1)
    torch.cuda.synchronize()
    _assert_hits_agree(kern, plain, alive)
    live = alive.cpu()
    for k in ("t", "idx"):
        assert torch.equal(shadow[k].cpu()[live], shadow_plain[k].cpu()[live])
    named = (alive & (excl >= 0)).cpu()
    hit = (shadow["t"] < fh.BIG).cpu()
    assert not bool((named & hit & (shadow["idx"] == excl).cpu()).any())
    assert not bool((named & (kern["t"] < fh.BIG).cpu()
                     & (kern["idx"] == excl).cpu()).any())
    # A lane that names no sphere keeps the result without the operand.
    free = (alive & (excl < 0)).cpu()
    assert torch.equal(shadow["t"].cpu()[free], first["t"].cpu()[free])


@pytest.mark.parametrize("num_spheres", [4, 300, 960])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_sphere_search_exclude_matches_plain_version(card, n, num_spheres):
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene = _scene(num_spheres, seed=num_spheres + 1).to(card)
    comps, alive = _rays(n, seed=n + 13, device=card)
    o = torch.stack(comps[:3], dim=1)
    d = torch.stack(comps[3:], dim=1)
    t0, i0 = si.sphere_search(scene, o, d, T_MIN, alive=alive)
    excl = _own_winner(i0, t0, alive)
    before = spans.counts["sphere_search"]
    kern = si.sphere_search(scene, o, d, T_MIN, alive=alive, exclude=excl)
    assert spans.counts["sphere_search"] == before + 1
    plain = si.sphere_search(scene, o, d, T_MIN, alive=alive, exclude=excl,
                             interpret=True)
    torch.cuda.synchronize()
    live = alive.cpu()
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu()[live], b.cpu()[live])
    assert torch.all(kern[0].cpu()[~live] == si.BIG)
    assert torch.all(kern[1].cpu()[~live] == 0)
    named = alive & (excl >= 0) & (kern[0] < si.BIG)
    assert not bool((named & (kern[1] == excl)).any())


@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh"])
def test_mesh_search_exclude_matches_plain_version(card, mesh_worlds, name,
                                                   n):
    mc = mesh_worlds[name]
    rays, alive, cap = _mesh_rays(mc, n, seed=n + 5, device=card)
    t0, i0 = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap)
    excl = _own_winner(i0, t0, alive)
    plain = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                           exclude=excl, interpret=True)
    live = alive.cpu()
    for sort in (False, True):
        got = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                             exclude=excl, sort=sort)
        for a, b in zip(got, plain):
            assert torch.equal(a.cpu()[live], b.cpu()[live]), sort
        named = alive & (excl >= 0) & (got[0] < fh.BIG)
        assert not bool((named & (got[1] == excl)).any())
        free = (alive & (excl < 0)).cpu()
        assert torch.equal(got[0].cpu()[free], t0.cpu()[free])


def _many_spheres(num_spheres: int, seed: int):
    """Random small Lambertian spheres in a 20-unit cube, Morton-ordered at
    build, with one emitter; on the CPU."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(num_spheres - 1):
        b.lambertian(rng.uniform(-10, 10, 3), rng.uniform(0.05, 0.4),
                     rng.random(3))
    b.emissive((0.0, 14.0, 0.0), 3.0, (6.0, 6.0, 6.0))
    return b.build(pad_to=128, device="cpu")


@pytest.mark.parametrize("num_spheres", [1024, 1062, 2112])
@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
def test_clustered_sphere_search_matches_plain_version(card, n, num_spheres):
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene = _many_spheres(num_spheres, seed=num_spheres).to(card)
    rng = np.random.default_rng(n)
    # Half the rows coherent (one pinhole, a narrow cone), half random.
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    half = n // 2
    o[:half] = (5.0, 5.0, 14.0)
    d[:half] = (0.0, 0.0, -1.0) + rng.uniform(-0.1, 0.1, (half, 3))
    alive = rng.random(n) >= 0.1
    if n >= 512:
        alive[256:384] = False
    o, d, alive = (torch.from_numpy(x).to(card) for x in (o, d, alive))
    before = _counts("sphere_search", "sphere_search_clustered")
    kern = si.sphere_search(scene, o, d, T_MIN, alive=alive)
    assert _counts("sphere_search", "sphere_search_clustered") == (
        before[0], before[1] + 1)
    plain = si.sphere_search(scene, o, d, T_MIN, alive=alive, interpret=True)
    mono = si.sphere_search(scene, o, d, T_MIN, alive=alive,
                            min_chunks=10 ** 6)
    assert _counts("sphere_search", "sphere_search_clustered") == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    live = alive.cpu()
    for a, b, c in zip(kern, plain, mono):
        assert torch.equal(a.cpu()[live], b.cpu()[live])
        assert torch.equal(a.cpu()[live], c.cpu()[live])
    assert torch.all(kern[0].cpu()[~live] == si.BIG)
    assert torch.all(kern[1].cpu()[~live] == 0)
    rays = [x[:, k].contiguous() for x in (o, d) for k in range(3)]
    gated = si.sphere_search_clustered_gated_plain(
        si.prep_sphere_search(scene), *rays, alive, T_MIN)
    _bitwise(kern, gated[:2])
    with pytest.raises(ValueError, match="clustered"):
        si.sphere_search(scene, o, d, T_MIN, alive=alive,
                         exclude=torch.full((n,), -1, dtype=torch.int32,
                                            device=card))


@pytest.mark.parametrize("name,intersector", [("cornell", "fused_diff"),
                                              ("cornell_mesh", "pallas")])
def test_edge_aware_gradients_on_card_match_cpu(card, name, intersector):
    # Loss and camera-pose gradient of a small edge-aware NEE render on the
    # card (the kernels with their exclude operands) against the CPU (the
    # plain versions): within 2e-3 of the largest entry.
    import dataclasses
    from qt_raytracer_tpu_torch.core import sampling
    cfg = RenderConfig(width=24, height=16, spp=2, max_depth=3, rng="hash",
                       nee=True, intersector=intersector, edge_aware=True)
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio, device="cpu")

    def grads(device):
        sc, c = scene.to(device), cam.to(device)
        tr = torch.zeros(3, device=device, requires_grad=True)
        c = dataclasses.replace(c, origin=c.origin + tr,
                                lower_left_corner=c.lower_left_corner + tr)
        img = render_linear(sc, c, cfg, sampling.prng_key(3))
        loss = ((img - 0.3) ** 2).mean()
        return [x.cpu() for x in (loss, *torch.autograd.grad(loss, [tr]))]

    on_card, on_cpu = grads(card), grads("cpu")
    for a, b in zip(on_card, on_cpu):
        assert bool(torch.isfinite(a).all())
        assert torch.allclose(a, b, rtol=2e-3,
                              atol=2e-3 * float(b.abs().max()))


# ------------------- pair-wavefront mesh search (A7, A8) and the A4 pair
def _list_widths(k: int):
    return sorted({1, min(6, k), k})


@pytest.fixture(scope="module")
def gate_worlds(card):
    """The cluster gate's meshes (tests/test_torch_cluster_gate.py), on the
    card: k = 1, G - 1, G, G + 1, 2G + 3, 9 and 35."""
    from test_torch_cluster_gate import gate_worlds as worlds
    return worlds(card)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("rays_kind", ["1", "127", "4097", "adversarial"])
@pytest.mark.parametrize("name", GATE_WORLDS)
def test_crossing_kernels_match_plain_versions(card, gate_worlds, name,
                                               rays_kind, capped):
    # A7 at list widths 1, 6 and k, and A4 with and without its second
    # output: integers, bitwise against the ungated plain versions and the
    # two-level walk's (crossing_walk_gated_plain); dead lanes hold k and a
    # count of 0. Seeded rays with dead lanes, and the rays of
    # tests/test_torch_cluster_gate.py on the gate's edges.
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    from test_torch_cluster_gate import adversarial_rays, check_walk
    mc = gate_worlds[name]
    if rays_kind == "adversarial":
        rays, alive, cap = adversarial_rays(mc, seed=mc.k + 1)
        rays, alive, cap = [r.to(card) for r in rays], alive.to(card), \
            cap.to(card)
    else:
        n = int(rays_kind)
        rays, alive, cap = _mesh_rays(mc, n, seed=n + 17, device=card)
    n = rays[0].shape[0]
    cap = cap if capped else None
    before = _counts("mesh_first_cluster", "mesh_first_cluster[pair]",
                     "mesh_crossing_lists")
    c1, c2 = mi.first_crossed_cluster(mc, *rays, T_MIN, alive, cap, pair=True)
    p1, p2 = mi.first_crossed_cluster(mc, *rays, T_MIN, alive, cap, pair=True,
                                      interpret=True)
    assert _counts("mesh_first_cluster", "mesh_first_cluster[pair]") == \
        (before[0], before[1] + 1)
    assert torch.equal(c1.cpu(), p1.cpu()) and torch.equal(c2.cpu(), p2.cpu())
    assert torch.equal(c1, mi.first_crossed_cluster(mc, *rays, T_MIN, alive,
                                                    cap))
    dead = ~alive.cpu()
    assert torch.all(c2.cpu()[dead] == mc.k)
    full_cap = torch.full_like(rays[0], fh.BIG) if cap is None else cap
    walk = check_walk(mc, rays, alive, full_cap, T_MIN)
    pair = mi.crossing_walk_gated_plain(mc, *rays, T_MIN, alive, full_cap, 2,
                                        stop=True)
    assert torch.equal(c1, pair[0][:, 0]) and torch.equal(c2, pair[0][:, 1])
    for j, c_max in enumerate(_list_widths(mc.k)):
        lists, ncross = mp.crossing_lists(mc, *rays, T_MIN, alive, cap, c_max)
        assert spans.counts["mesh_crossing_lists"] == before[2] + j + 1
        pl, pn = mp.crossing_lists(mc, *rays, T_MIN, alive, cap, c_max,
                                   interpret=True)
        assert lists.shape == (n, c_max) and lists.dtype == torch.int32
        assert torch.equal(lists.cpu(), pl.cpu())
        assert torch.equal(ncross.cpu(), pn.cpu())
        assert torch.equal(lists, walk[0][:, :c_max])
        assert torch.equal(ncross, walk[1])
        assert torch.equal(lists[:, 0], c1)
        if c_max > 1:
            assert torch.equal(lists[:, 1], c2)
        assert torch.all(lists.cpu()[dead] == mc.k)
        assert torch.all(ncross.cpu()[dead] == 0)
    assert spans.counts["mesh_crossing_lists"] == \
        before[2] + len(_list_widths(mc.k))
    # The walk's work: every group box of a live ray, members of open
    # groups only.
    assert torch.all(walk[2][alive] == mi.num_groups(mc.k))
    assert int(walk[3].sum()) <= int(alive.sum()) * mc.k


def test_crossing_kernels_need_rebuilt_group_boxes(card, gate_worlds):
    # What MeshClusters asks of group_boxes, on the card: cluster 0's box
    # moved past its group's box with the group boxes left stale, A4 and A7
    # follow the stale gate (the gated walk's ids) and miss crossings the
    # ungated plain versions find; rebuilt through with_cluster_boxes, they
    # equal both again.
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    from test_torch_cluster_gate import moved_box, seeded_rays
    rays, alive, cap = seeded_rays(gate_worlds["terrain48_rows1"], 1500,
                                   seed=7)
    rays, alive, cap = [r.to(card) for r in rays], alive.to(card), \
        cap.to(card)
    for mc, stale in zip(moved_box(gate_worlds["terrain48_rows1"], 0),
                         (True, False)):
        c1 = mi.first_crossed_cluster(mc, *rays, T_MIN, alive, cap)
        lists, ncross = mp.crossing_lists(mc, *rays, T_MIN, alive, cap, 6)
        walk = mi.crossing_walk_gated_plain(mc, *rays, T_MIN, alive, cap, 6)
        assert torch.equal(c1, walk[0][:, 0])
        assert torch.equal(lists, walk[0]) and torch.equal(ncross, walk[1])
        plain = mi.first_crossed_cluster_plain(mc, *rays, T_MIN, alive, cap)
        assert torch.equal(c1, plain) != stale
        assert torch.equal(ncross, mp.crossing_lists_plain(
            mc, *rays, T_MIN, alive, cap, 6)[1]) != stale


@pytest.mark.parametrize("n", [1, 127, 4097])
@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh"])
def test_pair_kernel_matches_plain_version(card, mesh_worlds, name, n):
    # A8 on the slots the pipeline builds from A7's lists: bitwise per pair,
    # (BIG, 0) on padding slots and in tiles without a valid pair.
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    mc = mesh_worlds[name]
    rays, alive, cap = _mesh_rays(mc, n, seed=n + 19, device=card)
    for c_max in _list_widths(mc.k):
        lists, _ = mp.crossing_lists(mc, *rays, T_MIN, alive, cap, c_max)
        ray_buf, gmap = mp.pair_slots(lists, mc.k)
        valid = ray_buf >= 0
        before = spans.counts["mesh_pairs"]
        t, idx = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN)
        assert spans.counts["mesh_pairs"] == before + 1
        pt, pidx = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN,
                                interpret=True)
        assert spans.counts["mesh_pairs"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(t.cpu(), pt.cpu())
        assert torch.equal(idx.cpu(), pidx.cpu())
        assert torch.all(t[~valid] == fh.BIG) and torch.all(idx[~valid] == 0)
        assert bool((t[valid] < fh.BIG).any()) or n == 1


@pytest.mark.parametrize("budget", [0, 1024])
@pytest.mark.parametrize("n", [1, 127, 4097])
@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh"])
def test_pair_search_equals_clustered_search(card, mesh_worlds, name, n,
                                             budget):
    # The whole pipeline on the card, kernels against the clustered search
    # and against its own plain versions: bitwise on live lanes, (BIG, 0)
    # on dead ones; pair_budget=1024 puts most of 4,097 rays on the
    # overflow fallback.
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    mc = mesh_worlds[name]
    rays, alive, cap = _mesh_rays(mc, n, seed=n + 23, device=card)
    ref = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap)
    got = mp.mesh_search_pairs(mc, *rays, T_MIN, alive, cap,
                               pair_budget=budget)
    plain = mp.mesh_search_pairs(mc, *rays, T_MIN, alive, cap,
                                 pair_budget=budget, interpret=True)
    live = alive.cpu()
    for a, b, c in zip(got, ref, plain):
        assert torch.equal(a.cpu()[live], b.cpu()[live])
        assert torch.equal(a.cpu(), c.cpu())
    assert torch.all(got[0].cpu()[~live] == fh.BIG)
    assert torch.all(got[1].cpu()[~live] == 0)


@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh"])
def test_pair_search_all_dead(card, mesh_worlds, name):
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    mc = mesh_worlds[name]
    rays, alive, cap = _mesh_rays(mc, 4097, seed=29, device=card)
    dead = torch.zeros_like(alive)
    t, idx = mp.mesh_search_pairs(mc, *rays, T_MIN, dead, cap)
    assert torch.all(t.cpu() == fh.BIG) and torch.all(idx.cpu() == 0)
    lists, ncross = mp.crossing_lists(mc, *rays, T_MIN, dead, cap,
                                      min(6, mc.k))
    assert torch.all(lists.cpu() == mc.k) and torch.all(ncross.cpu() == 0)
    c1, c2 = mi.first_crossed_cluster(mc, *rays, T_MIN, dead, cap, pair=True)
    assert torch.all(c1.cpu() == mc.k) and torch.all(c2.cpu() == mc.k)


@pytest.mark.parametrize("sort_mode", ["crossing2", "morton"])
def test_sort_modes_on_card_keep_live_lanes(card, mesh_worlds, sort_mode):
    mc = mesh_worlds["terrain48"]
    rays, alive, cap = _mesh_rays(mc, 4097, seed=31, device=card)
    ref = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap)
    before = _counts("mesh_first_cluster", "mesh_first_cluster[pair]")
    got = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                         sort_mode=sort_mode)
    pair = sort_mode == "crossing2"
    assert _counts("mesh_first_cluster", "mesh_first_cluster[pair]") == \
        (before[0], before[1] + pair)
    for a, b in zip(got, ref):
        assert torch.equal(a[alive], b[alive])


@pytest.mark.parametrize("option", [
    dict(mesh_kernel="pairs"), dict(mesh_kernel="hybrid"),
    dict(mesh_sort0=False), dict(mesh_compact=True),
    dict(mesh_sort_mode="crossing2"), dict(mesh_kernel="pairs",
                                           mesh_pair_c=1)])
def test_world_render_options_on_card_are_bit_identical(card, option):
    # Every mesh-search option gives the default frame bit for bit, and its
    # launches are the ones its policy names: 2 samples x 5 bounces of one
    # 2,304-ray chunk.
    import dataclasses
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    world = meshes.terrain_world(48, 48, device="cpu").to(card)
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=5, rng="hash",
                       pixel_chunk=-1)
    cam = meshes.terrain_camera(cfg.aspect_ratio, device="cpu").to(card)
    want = render_linear(world, cam, cfg, 5)
    spans.counts.clear()
    got = render_linear(world, cam, dataclasses.replace(cfg, **option), 5)
    assert torch.equal(got, want)
    counts = _counts("mesh_search", "mesh_first_cluster",
                     "mesh_first_cluster[pair]", "mesh_crossing_lists",
                     "mesh_pairs")
    kernel = option.get("mesh_kernel", "clustered")
    if kernel == "pairs":
        assert counts == (10, 10, 0, 10, 10)
    elif kernel == "hybrid":
        assert counts == (10, 10, 0, 8, 8)
    elif option.get("mesh_sort0") is False:
        assert counts == (10, 8, 0, 0, 0)
    elif option.get("mesh_sort_mode") == "crossing2":
        assert counts == (10, 0, 10, 0, 0)
    else:
        assert counts == (10, 10, 0, 0, 0)


# ------------- A3's row-gated and bilinear-form instances, cluster sizes
@pytest.fixture(scope="module")
def mesh_bodies(card):
    """The two meshes with the row boxes and the factor planes, and the
    terrain in clusters of one and two 128-triangle rows."""
    worlds = {"terrain48": meshes.terrain_world(48, 48, device="cpu"),
              "cornell_mesh": meshes.cornell_box_world(device="cpu")}
    out = {k: mi.prep_mesh_clusters(w.mesh.to(card), mt="mxu")
           for k, w in worlds.items()}
    for rows in (1, 2):
        out[f"terrain48_rows{rows}"] = mi.prep_mesh_clusters(
            worlds["terrain48"].mesh.to(card), cluster_rows=rows, mt="mxu")
    return out


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("n", [1, 255, 4097])
@pytest.mark.parametrize("body", ["rowgate", "mxu"])
@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh",
                                  "terrain48_rows1"])
def test_mesh_bodies_match_plain_versions(card, mesh_bodies, name, body, n,
                                          exclude):
    # Each instance, with and without the exclude operand, bitwise equal to
    # its plain version on every lane; the row gate also to A3's default
    # instance, the bilinear form in agreement with it.
    mc = mesh_bodies[name]
    rays, alive, cap = _mesh_rays(mc, n, seed=n + 17, device=card)
    kw = dict(visit="rowgate") if body == "rowgate" else dict(mt="mxu")
    base = mi.mesh_hits(mc, *rays, T_MIN, alive, cap)
    excl = _own_winner(base[1], base[0], alive) if exclude else None
    a3 = ("mesh_search", "mesh_search[rowgate]", "mesh_search[mxu]",
          "mesh_search[exclude]")
    before = _counts(*a3)
    got = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=excl, **kw)
    assert _counts(*a3) == (before[0] + 1, before[1] + (body == "rowgate"),
                            before[2] + (body == "mxu"), before[3] + exclude)
    plain = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=excl,
                         interpret=True, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert torch.equal(a.cpu(), b.cpu())
    live = alive.cpu()
    ref = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=excl)
    if body == "rowgate":
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu()[live], b.cpu()[live])
    elif n > 1000:
        # The same winner, or a tie at the same t: the Cornell boxes stand
        # on the floor's plane, and rounding decides between coplanar
        # triangles.
        tie = (got[0] - ref[0]).abs() <= 1e-4 * ref[0].abs()
        agree = ((got[1] == ref[1]) | tie).cpu()[live].float().mean()
        assert float(agree) >= 0.999
    if exclude:
        named = alive & (excl >= 0) & (got[0] < fh.BIG)
        assert not bool((named & (got[1] == excl)).any())


@pytest.mark.parametrize("sort_mode", ["crossing", "crossing2"])
@pytest.mark.parametrize("rows", [1, 2])
def test_cluster_sizes_on_card_keep_live_lanes(card, mesh_worlds, mesh_bodies,
                                               rows, sort_mode):
    # A smaller cluster, under each body and sort key, gives the default
    # search's bits on live lanes; the bilinear form its own bits under
    # every sort key.
    mc = mesh_bodies[f"terrain48_rows{rows}"]
    rays, alive, cap = _mesh_rays(mc, 4097, seed=37 + rows, device=card)
    ref = mi.mesh_search(mesh_worlds["terrain48"], *rays, T_MIN, alive=alive,
                         t_cap=cap)
    for visit in ("full", "rowgate", "sliced"):
        got = mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap,
                             visit=visit, sort_mode=sort_mode)
        for a, b in zip(got, ref):
            assert torch.equal(a[alive], b[alive]), visit
    mxu = [mi.mesh_search(mc, *rays, T_MIN, alive=alive, t_cap=cap, mt="mxu",
                          sort_mode=m) for m in ("crossing", sort_mode)]
    for a, b in zip(*mxu):
        assert torch.equal(a[alive], b[alive])


@pytest.mark.parametrize("option", [
    dict(mesh_visit="rowgate"), dict(mesh_cluster_rows=1),
    dict(mesh_visit="subtile"), dict(mesh_visit="sliced"),
    dict(mesh_mt="mxu")])
def test_world_render_search_bodies_on_card(card, option):
    # The row gate, the cluster size and the subtile and sliced visits
    # give the default frame bit for bit; the bilinear form stays within
    # the flip budget. Launches: 2 samples x 5 bounces of one chunk.
    import dataclasses
    world = meshes.terrain_world(48, 48, device="cpu").to(card)
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=5, rng="hash",
                       pixel_chunk=-1)
    cam = meshes.terrain_camera(cfg.aspect_ratio, device="cpu").to(card)
    want = render_linear(world, cam, cfg, 5)
    spans.counts.clear()
    got = render_linear(world, cam, dataclasses.replace(cfg, **option), 5)
    assert _counts("mesh_search", "mesh_search[rowgate]",
                   "mesh_search[mxu]") == (
        10, 10 * (option.get("mesh_visit") == "rowgate"),
        10 * (option.get("mesh_mt") == "mxu"))
    if "mesh_mt" in option:
        bad = (got - want).abs() > 2e-3 + 2e-3 * want.abs()
        assert float(bad.float().mean()) <= 0.01
    else:
        assert torch.equal(got, want)


# ----------------- adversarial cases of the redesigned sweeps (A1, A2, A5, A3)
def _tie_spheres(num_spheres: int):
    """num_spheres slots: the ground, then random spheres, with copies of
    some of them at ids in another lane (+1), another 32-slot group (+33)
    and another 64-slot group (+70) where S allows, and in slot 45 a sphere
    of radius -0.5 (a hollow sphere's inner surface) far from the rest of
    its group; built on the CPU. Returns (scene, the ids the rays aim at:
    those whose copies tie with them, and the hollow one)."""
    rng = np.random.default_rng(num_spheres)
    rows = [((0.0, -1000.0, 0.0), 1000.0)]
    while len(rows) < num_spheres:
        rows.append(((rng.uniform(-6, 6), rng.uniform(0.3, 1.0),
                      rng.uniform(-6, 6)), rng.uniform(0.1, 0.3)))
    sources = []
    for src in (3, 7, 20):
        if src < num_spheres:
            # Above the others, so that rays aimed at it reach it.
            rows[src] = ((rng.uniform(-4, 4), 2.0, rng.uniform(-4, 4)), 0.4)
        for off in (1, 33, 70):
            if src + off < num_spheres:
                rows[src + off] = rows[src]
                sources.append(src)
    if num_spheres > 45:
        rows[45] = ((8.0, 3.2, -8.0), -0.5)
        sources.append(45)
    b = SceneBuilder()
    for c, r in rows:
        b.lambertian(c, r, (0.5, 0.5, 0.5))
    return (b.build(pad_to=None, spatial_sort=False, device="cpu"),
            sorted(set(sources)))


def _aimed_rays(centers: np.ndarray, aim: list, n: int, seed: int, device,
                dead: float = 0.1):
    """n rays from above the spheres, half aimed at the centres of aim (the
    tied spheres); about `dead` of the lanes dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-7.0, 7.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(3.0, 5.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if aim:
        k = rng.random(n) < 0.5
        tgt = centers[rng.choice(aim, int(k.sum()))]
        d[k] = tgt + rng.normal(scale=0.05, size=tgt.shape) - o[k]
    alive = rng.random(n) >= dead
    comps = [torch.from_numpy(np.ascontiguousarray(x[:, a])).to(device)
             for x in (o, d) for a in range(3)]
    return comps, torch.from_numpy(alive).to(device)


def _bitwise(a, b):
    """Every lane equal: live lanes' results and dead lanes' defaults."""
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        assert torch.equal(x, y), int((x != y).sum())


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("n", [1, 257, 414721])
@pytest.mark.parametrize("num_spheres", [1, 63, 512, 1152])
def test_sweeps_bitwise_on_ties(card, num_spheres, n, exclude):
    """A1, A2 and A5 (monolithic, whatever S) against their plain versions
    on tied copies across lanes and groups; with exclude each ray leaves
    out its own winner, the lowest id of a tie, so the next copy wins."""
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene, aim = _tie_spheres(num_spheres)
    on = scene.to(card)
    tables = fh.prep_fused_spheres(on)
    rays, alive = _aimed_rays(scene.center.numpy(), aim, n, seed=n + 1,
                              device=card)
    ex = None
    if exclude:
        first = fh.fused_hit(tables, *rays, alive, T_MIN, shadow_only=True)
        ex = torch.where(alive & (first["t"] < fh.BIG), first["idx"],
                         -1).to(torch.int32)
    kern = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=ex)
    plain = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=ex,
                         interpret=True)
    _bitwise([kern[k] for k in fh.NAMES], [plain[k] for k in fh.NAMES])
    k2 = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=ex,
                      shadow_only=True)
    p2 = fh.fused_hit(tables, *rays, alive, T_MIN, exclude=ex,
                      shadow_only=True, interpret=True)
    _bitwise((k2["t"], k2["idx"]), (p2["t"], p2["idx"]))
    stab = si.prep_sphere_search(on, min_chunks=10 ** 6)
    k5 = si.sphere_search_flat(stab, *rays, alive, T_MIN, exclude=ex)
    p5 = si.sphere_search_flat(stab, *rays, alive, T_MIN, exclude=ex,
                               interpret=True)
    _bitwise(k5, p5)
    if num_spheres >= 63 and n >= 257 and not exclude:
        # Ties were made: some live lane's sweep minimum is reached by a
        # copy too.
        tcand, _ = fh.sweep_candidates(tables.spheres, *(r[:4096] for r in
                                                          rays), T_MIN)
        t = p2["t"][:4096]
        assert bool((((tcand == t[:, None]).sum(1) > 1) & (t < fh.BIG)
                     & alive[:4096]).any())


@pytest.mark.parametrize("num_spheres", [63, 1152])
def test_sweeps_one_live_lane_and_all_dead(card, num_spheres):
    """A block with one live lane (the compaction's single-ray warp) and
    blocks with none: A1, A2 and A5 against their plain versions."""
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene, aim = _tie_spheres(num_spheres)
    on = scene.to(card)
    tables = fh.prep_fused_spheres(on)
    stab = si.prep_sphere_search(on, min_chunks=10 ** 6)
    rays, alive = _aimed_rays(scene.center.numpy(), aim, 1024, seed=3,
                              device=card, dead=0.0)
    for mask in (torch.arange(1024, device=card) == 300,
                 torch.zeros(1024, dtype=torch.bool, device=card)):
        kern = fh.fused_hit(tables, *rays, mask, T_MIN)
        plain = fh.fused_hit(tables, *rays, mask, T_MIN, interpret=True)
        _bitwise([kern[k] for k in fh.NAMES], [plain[k] for k in fh.NAMES])
        k5 = si.sphere_search_flat(stab, *rays, mask, T_MIN)
        p5 = si.sphere_search_flat(stab, *rays, mask, T_MIN, interpret=True)
        _bitwise(k5, p5)


@pytest.fixture(scope="module")
def tie_meshes(card):
    """The 48x48 terrain at clusters of 1, 2 and 4 rows and the one-cluster
    Cornell mesh (k = 1), each with copies of triangles in another lane,
    the same lane one step on, and another cluster; and the sources."""
    worlds = {"terrain48": meshes.terrain_world(48, 48, device="cpu"),
              "cornell_mesh": meshes.cornell_box_world(device="cpu")}
    out = {}
    for name, rows in (("terrain48", 1), ("terrain48", 2), ("terrain48", 4),
                       ("cornell_mesh", 4)):
        mesh = worlds[name].mesh
        mc = mi.prep_mesh_clusters(mesh, cluster_rows=rows, mt="mxu")
        g, p = mc.tris_per_cluster, mesh.num_triangles
        if name == "cornell_mesh":
            srcs, dsts = [0, 5, 17], [p + 1, p + 37, p + 45]
        else:
            srcs = [3, g + 40, 2 * g + 7]
            dsts = [4, g + 72, mc.k * g - 3]
        mc = with_copies(mc, mesh, list(zip(srcs, dsts)))
        mc = mc._replace(**{f: getattr(mc, f).to(card) for f in (
            "tri_planes", "box_planes", "row_boxes", "group_boxes", "root_lo",
            "root_hi", "mt_planes")})
        out[f"{name}_rows{rows}"] = (mc, srcs)
    return out


def _tie_mesh_rays(mc, srcs, n: int, seed: int, device):
    """n rays over the mesh's root box, half aimed at the copied
    triangles' centroids; 80% alive, half capped."""
    rng = np.random.default_rng(seed)
    lo, hi = mc.root_lo.cpu().numpy(), mc.root_hi.cpu().numpy()
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    o[:, 1] = hi[1] + 1.0 if mc.k > 1 else o[:, 1]
    tp = mc.tri_planes.cpu().numpy()
    cen = (3 * tp[0:3] + tp[3:6] + tp[6:9]).T[srcs] / 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = rng.random(n) < 0.5
    d[k] = cen[rng.integers(0, len(srcs), int(k.sum()))] \
        + rng.normal(scale=0.01, size=(int(k.sum()), 3)) - o[k]
    alive = rng.random(n) < 0.8
    cap = np.where(rng.random(n) < 0.5, rng.uniform(0.3, 3.0, n),
                   fh.BIG).astype(np.float32)
    comps = [torch.from_numpy(np.ascontiguousarray(
        x[:, a].astype(np.float32))).to(device) for x in (o, d)
        for a in range(3)]
    return (comps, torch.from_numpy(alive).to(device),
            torch.from_numpy(cap).to(device))


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("visit", ["full", "rowgate"])
@pytest.mark.parametrize("n", [1, 257, 414721])
@pytest.mark.parametrize("name", ["terrain48_rows1", "terrain48_rows2",
                                  "terrain48_rows4", "cornell_mesh_rows4"])
def test_mesh_search_bitwise_on_ties(card, tie_meshes, name, n, visit,
                                     exclude):
    """A3's VPU and ROWGATE instances against their plain versions on
    copies across lanes and clusters, at clusters of 1, 2 and 4 rows and
    k = 1; with exclude each ray leaves out its own winner."""
    mc, srcs = tie_meshes[name]
    rays, alive, cap = _tie_mesh_rays(mc, srcs, n, seed=n, device=card)
    ex = None
    if exclude:
        t0, i0 = mi.mesh_hits(mc, *rays, T_MIN, alive, cap)
        ex = torch.where(alive & (t0 < fh.BIG), i0, -1).to(torch.int32)
    kern = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=ex, visit=visit)
    plain = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=ex,
                         visit=visit, interpret=True)
    _bitwise(kern, plain)
    if n == 414721 and not exclude:
        hits = plain[0].cpu() < fh.BIG
        assert int(torch.isin(plain[1].cpu()[hits],
                              torch.tensor(srcs)).sum()) > 100


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("n", [1, 257, 414721])
@pytest.mark.parametrize("name", ["terrain48_rows1", "terrain48_rows2",
                                  "terrain48_rows4", "cornell_mesh_rows4"])
def test_mxu_search_bitwise_on_ties(card, tie_meshes, name, n, exclude):
    """A3m (mt="mxu": blocks of 64 rays, TF32 filter, exact re-test) against
    its plain version on the tie meshes: copies across lanes, 8-triangle
    tiles and clusters; with exclude each ray leaves out its own winner."""
    mc, srcs = tie_meshes[name]
    rays, alive, cap = _tie_mesh_rays(mc, srcs, n, seed=n + 3, device=card)
    ex = None
    if exclude:
        t0, i0 = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, mt="mxu")
        ex = torch.where(alive & (t0 < fh.BIG), i0, -1).to(torch.int32)
    kern = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=ex, mt="mxu")
    plain = mi.mesh_hits(mc, *rays, T_MIN, alive, cap, exclude=ex, mt="mxu",
                         interpret=True)
    _bitwise(kern, plain)
    if n == 414721 and not exclude:
        hits = plain[0].cpu() < fh.BIG
        assert int(torch.isin(plain[1].cpu()[hits],
                              torch.tensor(srcs)).sum()) > 100


@pytest.mark.parametrize("t_min", [T_MIN, 0.0, -0.5])
@pytest.mark.parametrize("shift", [0, 7, 40])
@pytest.mark.parametrize("exclude", [False, True])
def test_mxu_search_bitwise_on_adversarial_pairs(card, exclude, shift, t_min):
    """A3m against its plain version on torch_helpers.mxu_adversarial (rays
    through vertices and edges, grazing rays, |det| within ulps of 1e-12, t
    at t_min, at 0 and at the cap, coordinates up to 1e4, a subnormal
    direction, a u that underflows to -0.0), behind shift dead lanes so
    that the rays land in other tiles and blocks; at t_min 0 and below,
    hits at t = +-0 and behind the origin count, which the kernel's (t, id)
    keys must order as the serial sweep does.
    tests/test_torch_mxu_filter.py holds the filter sound on the same pairs
    on the CPU."""
    mesh, rays, cap = mxu_adversarial(seed=1)
    mc = mi.prep_mesh_clusters(mesh.to(card), mt="mxu")
    n = rays[0].shape[0] + shift
    pad = lambda x, v: torch.cat([torch.full((shift,), v, dtype=x.dtype), x])
    rays = [pad(x, 0.0).to(card) for x in rays]
    cap = pad(cap, fh.BIG).to(card)
    alive = torch.ones(n, dtype=torch.bool, device=card)
    alive[:shift] = False
    ex = None
    if exclude:
        t0, i0 = mi.mesh_hits(mc, *rays, t_min, alive, cap, mt="mxu",
                              interpret=True)
        ex = torch.where(alive & (t0 < fh.BIG), i0, -1).to(torch.int32)
    kern = mi.mesh_hits(mc, *rays, t_min, alive, cap, exclude=ex, mt="mxu")
    plain = mi.mesh_hits(mc, *rays, t_min, alive, cap, exclude=ex, mt="mxu",
                         interpret=True)
    _bitwise(kern, plain)
    assert int((plain[0] < fh.BIG).sum()) > (20 if exclude else 300)


@pytest.mark.parametrize("visit", ["full", "rowgate"])
def test_mesh_search_one_heavy_lane(card, visit):
    """One live ray that grazes the terrain across most clusters, in a warp
    of 31 dead lanes, and warps with no live ray: bitwise."""
    world = meshes.terrain_world(48, 48, device="cpu")
    mc = mi.prep_mesh_clusters(world.mesh.to(card), cluster_rows=1)
    lo, hi = mc.root_lo.cpu().numpy(), mc.root_hi.cpu().numpy()
    o = np.array([lo[0] - 0.1, hi[1] + 0.01, lo[2] - 0.1], np.float32)
    d = np.array([hi[0] - lo[0], lo[1] - hi[1], hi[2] - lo[2]], np.float32)
    n = 96
    rays = [torch.full((n,), float(v), device=card) for v in (*o, *d)]
    alive = torch.zeros(n, dtype=torch.bool, device=card)
    alive[37] = True
    c1 = mi.first_crossed_cluster(mc, *rays, T_MIN, alive, interpret=True,
                                  pair=True)
    assert int(c1[0][37]) < mc.k
    for mask in (alive, torch.zeros_like(alive)):
        kern = mi.mesh_hits(mc, *rays, T_MIN, mask, visit=visit)
        plain = mi.mesh_hits(mc, *rays, T_MIN, mask, visit=visit,
                             interpret=True)
        _bitwise(kern, plain)
    _, _, visits = mi.mesh_search_gated_plain(mc, *rays, T_MIN, alive,
                                              torch.full((n,), fh.BIG,
                                                         device=card))
    assert visits > mc.k // 4      # the ray crosses many clusters


# -------------- adversarial cases of the redesigned A6 and A8 (row gates)
@pytest.mark.parametrize("n", [1, 257, 414721])
@pytest.mark.parametrize("num_spheres", [1152, 2112])
def test_clustered_sweep_bitwise_on_ties(card, num_spheres, n):
    """A6 against its plain version and its gated plain version on every
    lane, on tied copies across lanes, groups and chunks and a hollow
    sphere isolated in its group (K = 18 and 33 chunks), with dead lanes;
    and against A5 on live lanes."""
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    scene, aim = _tie_spheres(num_spheres)
    on = scene.to(card)
    tables = si.prep_sphere_search(on)
    assert tables.num_chunks == num_spheres // 64
    rays, alive = _aimed_rays(scene.center.numpy(), aim, n, seed=n + 5,
                              device=card)
    before = spans.counts["sphere_search_clustered"]
    kern = si.sphere_search_flat(tables, *rays, alive, T_MIN)
    assert spans.counts["sphere_search_clustered"] == before + 1
    plain = si.sphere_search_flat(tables, *rays, alive, T_MIN,
                                  interpret=True)
    _bitwise(kern, plain)
    gated = si.sphere_search_clustered_gated_plain(tables, *rays, alive,
                                                   T_MIN)
    _bitwise(kern, gated[:2])
    mono = si.sphere_search_flat(si.prep_sphere_search(on, 10 ** 6), *rays,
                                 alive, T_MIN)
    live = alive.cpu()
    for a, b in zip(kern, mono):
        assert torch.equal(a.cpu()[live], b.cpu()[live])
    if n == 414721:
        # The hollow sphere and the tied copies are reached.
        assert int((plain[1].cpu()[live] == 45).sum()) > 10


def test_clustered_sweep_two_mask_tiles(card):
    """More chunks than one shared tile of the row mask holds (2,188 of
    2,048): bitwise against the plain version on every lane."""
    from qt_raytracer_tpu_torch.kernels import sphere_intersect as si
    rng = np.random.default_rng(40)
    b = SceneBuilder()
    for _ in range(140000):
        b.lambertian(rng.uniform(-40, 40, 3), rng.uniform(0.05, 0.4),
                     rng.random(3))
    scene = b.build(pad_to=128, device="cpu").to(card)
    tables = si.prep_sphere_search(scene)
    assert tables.num_chunks > 2048
    n = 1000
    o = rng.uniform(-45, 45, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o[:500] = (5.0, 5.0, 50.0)
    d[:500] = (0.0, 0.0, -1.0) + rng.uniform(-0.2, 0.2, (500, 3))
    rays = [torch.from_numpy(np.ascontiguousarray(x[:, k])).to(card)
            for x in (o, d) for k in range(3)]
    alive = torch.from_numpy(rng.random(n) >= 0.1).to(card)
    kern = si.sphere_search_flat(tables, *rays, alive, T_MIN)
    plain = si.sphere_search_flat(tables, *rays, alive, T_MIN,
                                  interpret=True)
    _bitwise(kern, plain)
    assert bool((plain[0][alive] < si.BIG).any())


def _pair_slots_of(mp, mc, rays, alive, cap):
    lists, _ = mp.crossing_lists(mc, *rays, T_MIN, alive, cap, min(6, mc.k))
    return mp.pair_slots(lists, mc.k)


@pytest.mark.parametrize("n", [1, 257, 414721])
@pytest.mark.parametrize("name", ["terrain48_rows1", "terrain48_rows2",
                                  "terrain48_rows4", "cornell_mesh_rows4"])
def test_pair_kernel_bitwise_on_ties(card, tie_meshes, name, n):
    """A8 against its plain version and its row-gated plain version on
    every slot, on copies across lanes, rows and clusters, at clusters of
    1, 2 and 4 rows and the one-row Cornell cluster."""
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    mc, srcs = tie_meshes[name]
    rays, alive, cap = _tie_mesh_rays(mc, srcs, n, seed=n + 2, device=card)
    ray_buf, gmap = _pair_slots_of(mp, mc, rays, alive, cap)
    before = spans.counts["mesh_pairs"]
    kern = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN)
    assert spans.counts["mesh_pairs"] == before + 1
    plain = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN,
                         interpret=True)
    _bitwise(kern, plain)
    gated = mp.pair_hits_gated_plain(mc, *rays, cap, ray_buf, gmap, T_MIN)
    _bitwise(kern, gated[:2])
    valid = (ray_buf >= 0).cpu()
    assert bool((gated[2].cpu()[~valid] == 0).all())
    if n == 414721:
        hits = plain[0].cpu() < fh.BIG
        assert int(torch.isin(plain[1].cpu()[hits],
                              torch.tensor(srcs)).sum()) > 100


@pytest.mark.parametrize("name", ["terrain48_rows4", "cornell_mesh_rows4"])
def test_pair_kernel_single_valid_pair_tiles(card, tie_meshes, name):
    """Tiles that hold one valid pair, at the first, a middle and the last
    slot, beside tiles with none: bitwise on every slot."""
    from qt_raytracer_tpu_torch.kernels import mesh_pairs as mp
    mc, srcs = tie_meshes[name]
    n = 4096
    rays, alive, cap = _tie_mesh_rays(mc, srcs, n, seed=12, device=card)
    ray_buf, gmap = _pair_slots_of(mp, mc, rays, alive, cap)
    tiles = ray_buf.view(-1, 128).clone()
    for t in range(tiles.shape[0]):
        keep = (0, 77, 127)[t % 3]
        row = torch.full((128,), -1, dtype=tiles.dtype, device=card)
        if t % 4 != 3:
            row[keep] = (t * 131) % n
        tiles[t] = row
    ray_buf = tiles.reshape(-1).contiguous()
    kern = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN)
    plain = mp.pair_hits(mc, *rays, cap, ray_buf, gmap, T_MIN,
                         interpret=True)
    _bitwise(kern, plain)
    assert bool((plain[0] < fh.BIG).any())


# ---------------------------------------------------------- the app layer
APP_CFG = dict(width=96, height=54, spp=3, max_depth=4)


def test_cli_render_equals_render_on_card(card, tmp_path):
    """`cli render` on the card writes exactly the PNG of `render` on the
    card (the file's bytes: one encoder, one image)."""
    from qt_raytracer_tpu_torch import render
    from qt_raytracer_tpu_torch.app import cli
    from qt_raytracer_tpu_torch.app.png import encode_png
    out = tmp_path / "card.png"
    assert cli.main(["render", "--scene", "random", "--width", "96",
                     "--height", "54", "--spp", "3", "--depth", "4",
                     "--seed", "7", "--out", str(out)]) == 0
    cfg = RenderConfig(**APP_CFG)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    assert scene.device == card
    want = render(scene, cam, cfg, 7).cpu().numpy()
    assert out.read_bytes() == encode_png(want)


@pytest.mark.parametrize("name", ["random", "cornell_mesh"])
def test_progressive_1spp_steps_equal_batch_on_card(card, name):
    from qt_raytracer_tpu_torch.app.progressive import ProgressiveRenderer
    cfg = RenderConfig(**APP_CFG, nee=name == "cornell_mesh")
    scene, cam = scenes.get_scene(name, cfg.aspect_ratio)
    pr = ProgressiveRenderer(scene, cam, cfg, seed=4)
    for _ in range(cfg.spp):
        pr.step(1)
    assert pr.state.accum.device == card
    assert torch.equal(pr.state.accum, render_linear(scene, cam, cfg, 4))


def test_checkpoint_moves_between_card_and_cpu(card, tmp_path):
    """A checkpoint written on the card loads onto the CPU and continues
    there, and the reverse; each lands on its renderer's device."""
    from qt_raytracer_tpu_torch.app.progressive import ProgressiveRenderer
    cfg = RenderConfig(**APP_CFG)
    scene, cam = scenes.get_scene("three_sphere", cfg.aspect_ratio,
                                  device="cpu")
    on_card = ProgressiveRenderer(scene.to(card), cam.to(card), cfg, seed=2)
    on_cpu = ProgressiveRenderer(scene, cam, cfg, seed=9)
    on_card.step(2)
    on_card.save(tmp_path / "card.pt")
    on_cpu.load(tmp_path / "card.pt")
    assert on_cpu.state.accum.device.type == "cpu" and on_cpu.seed == 2
    assert torch.equal(on_cpu.state.accum, on_card.state.accum.cpu())
    on_cpu.step(1)
    on_cpu.save(tmp_path / "cpu.pt")
    back = ProgressiveRenderer(scene.to(card), cam.to(card), cfg, seed=0)
    back.load(tmp_path / "cpu.pt")
    assert back.state.accum.device == card and back.frame_index == 3
    assert torch.equal(back.state.accum.cpu(), on_cpu.state.accum)
    back.step(1)
    full = ProgressiveRenderer(scene, cam, cfg, seed=2)
    full.step(4)
    got, want = back.state.accum.cpu() / 4, full.state.accum / 4
    bad = (got - want).abs() > 2e-3 + 2e-3 * want.abs()
    assert float(bad.float().mean()) <= 0.01


def test_device_memory_stats_on_card(card):
    from qt_raytracer_tpu_torch.app.profiling import device_memory_stats
    x = torch.ones(1 << 20, device=card)
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count() >= 1
    assert stats[0]["allocated_bytes.all.current"] >= x.numel() * 4


def test_trace_holds_the_annotated_span_and_kernels(card, tmp_path):
    from qt_raytracer_tpu_torch.app.profiling import annotate, trace
    cfg = RenderConfig(width=64, height=36, spp=1, max_depth=2)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio)
    render_linear(scene, cam, cfg, 0)          # build and warm up
    with trace(str(tmp_path)) as prof:
        with annotate("qtrt_card_span"):
            render_linear(scene, cam, cfg, 0)
    import json
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert "qtrt_card_span" in names
    assert any("fused_hit_kernel" in k for k in kernels), sorted(kernels)[:20]


def test_trace_puts_the_backward_under_the_port_spans(card, tmp_path):
    # On the card autograd runs the backward on its own thread: the chunk
    # spans of the checkpoint's recompute open there, inside the calling
    # thread's qtrt.train.backward, and launch the recompute's kernels.
    from qt_raytracer_tpu_torch.app.profiling import trace
    from qt_raytracer_tpu_torch.diff import inverse
    cfg = RenderConfig(width=64, height=36, spp=1, max_depth=3, nee=True)
    scene, cam = scenes.get_scene("cornell", cfg.aspect_ratio)
    init, step, _, _ = inverse.make_train_step(
        scene, cam, cfg, inverse.adam(0.05), trainable=("albedo",))
    target = torch.zeros((cfg.height, cfg.width, 3), device=card)
    state, _ = step(init(), target, 0)         # build and warm up
    with trace(str(tmp_path)) as prof:
        step(state, target, 1)
    import json
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] in spans.SPANS]
    back = [e for e in ours if e["name"] == spans.TRAIN_BACKWARD]
    assert len(back) == 1
    b0, b1 = back[0]["ts"], back[0]["ts"] + back[0]["dur"]
    redo = [e for e in ours if e["name"] == spans.CHUNK
            and b0 <= e["ts"] and e["ts"] + e["dur"] <= b1]
    assert redo and all(e["tid"] != back[0]["tid"] for e in redo)
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime" and "correlation" in
             e.get("args", {})}
    launched = [calls[k["args"]["correlation"]] for k in events
                if k.get("cat") == "kernel"
                and k["args"].get("correlation") in calls]
    inside = [c for c in launched if any(
        r["tid"] == c["tid"] and r["ts"] <= c["ts"] <= r["ts"] + r["dur"]
        for r in redo)]
    assert inside


@pytest.fixture(scope="module")
def walk_meshes(card):
    """The terrain crop, the Cornell mesh and the icosphere, on the card."""
    return {"terrain48": meshes.terrain_world(48, 48, device="cpu").mesh,
            "cornell_mesh": meshes.cornell_box_world(device="cpu").mesh,
            "icosphere": meshes.icosphere_world(2, device="cpu").mesh}


def _walk_rays(mesh, n: int, seed: int):
    """n rays [N, 3] from around the mesh's root box, 80% alive, an
    excluded triangle on a tenth of the lanes; on the CPU."""
    rng = np.random.default_rng(seed)
    lo, hi = mesh.bvh_min[0].numpy(), mesh.bvh_max[0].numpy()
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.8
    excl = np.where(rng.random(n) < 0.1,
                    rng.integers(0, mesh.num_triangles, n), -1)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(alive), torch.from_numpy(excl.astype(np.int32)))


@pytest.mark.parametrize("opts", ["none", "alive", "exclude", "t_max"])
@pytest.mark.parametrize("n", [1, 127, 1000, 4097])
@pytest.mark.parametrize("name", ["terrain48", "cornell_mesh", "icosphere"])
def test_bvh_walk_matches_plain_version(card, walk_meshes, name, n, opts):
    # Bitwise on live lanes, (BIG, 0) on dead lanes; the exclude instance
    # has its own counter.
    from qt_raytracer_tpu_torch.kernels import bvh_walk as bw
    mesh = walk_meshes[name]
    o, d, alive, excl = _walk_rays(mesh, n, seed=n + len(name))
    kw = {}
    if opts != "none":
        kw["alive"] = alive
    if opts == "exclude":
        kw["exclude"] = excl
    t_max = 1.5 if opts == "t_max" else bw.BIG
    plain = bw.bvh_walk(mesh, o, d, T_MIN, t_max, **kw)
    on = mesh.to(card)
    before = _counts("bvh_walk", "bvh_walk[exclude]")
    got = bw.bvh_walk(on, o.to(card), d.to(card), T_MIN, t_max,
                      **{k: v.to(card) for k, v in kw.items()})
    assert _counts("bvh_walk", "bvh_walk[exclude]") == (
        before[0] + 1, before[1] + (opts == "exclude"))
    on_card = bw.bvh_walk(on, o.to(card), d.to(card), T_MIN, t_max,
                          interpret=True,
                          **{k: v.to(card) for k, v in kw.items()})
    live = kw.get("alive", torch.ones(n, dtype=torch.bool))
    for a, b, c in zip(got, plain, on_card):
        a, c = a.cpu(), c.cpu()
        assert torch.equal(a[live], c[live])
        assert torch.equal(a[live], b[live])
    assert torch.all(got[0].cpu()[~live] == bw.BIG)
    assert torch.all(got[1].cpu()[~live] == 0)
    if opts == "t_max":
        t = got[0].cpu()[live]
        assert bool(((t <= 1.5) | (t == bw.BIG)).all())


def test_xla_sphere_ts_ignore_the_tf32_switch(card):
    # The [N, S] search writes its products out in full float32: the
    # global TF32 switch of matrix products changes no bit.
    from qt_raytracer_tpu_torch.core.intersect import intersect_spheres
    scene = _scene(300, seed=4).to(card)
    rays, _ = _rays(4097, seed=8, device=card)
    o, d = torch.stack(rays[:3], 1), torch.stack(rays[3:], 1)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want = intersect_spheres(scene, o, d, T_MIN, backend="xla")
        torch.backends.cuda.matmul.allow_tf32 = True
        got = intersect_spheres(scene, o, d, T_MIN, backend="xla")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cpu = intersect_spheres(_scene(300, seed=4), o.cpu(), d.cpu(), T_MIN,
                            backend="xla")
    assert float((got.prim_idx.cpu() == cpu.prim_idx).float().mean()) > 0.999


def test_bvh_walk_raises_when_the_library_cannot_build(card, walk_meshes,
                                                       monkeypatch):
    # A CUDA tensor takes the kernel or raises; it never falls back to the
    # plain walk.
    from qt_raytracer_tpu_torch.kernels import bvh_walk as bw
    from qt_raytracer_tpu_torch.runtime import cuda_build

    def unbuildable():
        raise RuntimeError("nvcc failed: the library cannot be built")

    monkeypatch.setattr(cuda_build, "load_library", unbuildable)
    mesh = walk_meshes["terrain48"].to(card)
    o, d, _, _ = _walk_rays(walk_meshes["terrain48"], 64, seed=2)
    before = spans.counts["bvh_walk"]
    with pytest.raises(RuntimeError, match="cannot be built"):
        bw.bvh_walk(mesh, o.to(card), d.to(card), T_MIN)
    assert spans.counts["bvh_walk"] == before


@pytest.mark.parametrize("name", ["cornell_mesh_nee", "terrain48"])
def test_xla_world_render_on_card_matches_cpu(card, name):
    from qt_raytracer_tpu_torch.kernels import bvh_walk as bw
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=4, rng="hash",
                       nee=name.endswith("nee"), intersector="xla")
    world = meshes.cornell_box_world(device="cpu") if name.startswith(
        "cornell") else meshes.terrain_world(48, 48, device="cpu")
    cam = (meshes.cornell_box_mesh_camera if name.startswith("cornell")
           else meshes.terrain_camera)(cfg.aspect_ratio, device="cpu")
    before = spans.counts["bvh_walk"]
    got = render_linear(world.to(card), cam.to(card), cfg, 3).cpu()
    assert spans.counts["bvh_walk"] > before
    want = render_linear(world, cam, cfg, 3)
    bad = (got - want).abs() > 2e-3 + 2e-3 * want.abs()
    assert bool(torch.isfinite(got).all())
    assert float(bad.float().mean()) <= 0.01


# ------------------------------------------------- the shading kernel
def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.is_floating_point() else x


def _assert_states_bitwise(got, want):
    for name, a, b in zip(itf.RayState._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("depth_idx,rr_start", [(0, 0), (1, 2), (3, 2)])
@pytest.mark.parametrize("n", [1, 1023, 1025, 414720])
def test_shade_kernel_matches_pytorch_route(card, n, depth_idx, rr_start):
    # Every output field on every lane, dead lanes, NaN and inf included,
    # bit for bit against the PyTorch route on the card; roulette off, on
    # below its start depth and on above it. _shade takes the kernel.
    from qt_raytracer_tpu_torch.kernels import fused_shade as fs
    s, h = shade_inputs(n, seed=n + depth_idx, depth_idx=depth_idx,
                        device=card)
    want = itf._shade_plain(s, h, depth_idx, rr_start, 1.0, None)
    before = spans.counts["fused_shade"]
    got = itf.RayState(*fs.fused_shade(s, h, depth_idx, rr_start),
                       s.prev_pdf, s.keys, s.pid)
    assert spans.counts["fused_shade"] == before + 1
    _assert_states_bitwise(got, want)
    routed = itf._shade(s, h, depth_idx, rr_start, 1.0, None)
    assert spans.counts["fused_shade"] == before + 2
    _assert_states_bitwise(routed, want)


def _frame(name: str):
    if name == "terrain48":
        world = meshes.terrain_world(48, 48, device="cpu")
        cfg = RenderConfig(width=48, height=48, spp=2, max_depth=5,
                           rng="hash", pixel_chunk=-1)
        cam = meshes.terrain_camera(cfg.aspect_ratio, device="cpu")
        return world, cam, cfg, 2          # one chunk, two samples
    cfg = RenderConfig(width=96, height=54, spp=1, max_depth=10, rng="hash",
                       pixel_chunk=1024,
                       rr_start=3 if name == "random_rr" else 0)
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio, device="cpu")
    return scene, cam, cfg, 6              # 5,184 rays in 6 chunks


@pytest.mark.parametrize("name", ["random", "random_rr", "terrain48"])
def test_frames_with_shade_kernel_are_bit_identical(card, name, monkeypatch):
    # A book-cover-like sphere frame and a mesh-world frame: the kernel on
    # every bounce (calls x depth launches), and the frame equal bit for
    # bit to the same frame with the PyTorch route on the card.
    from qt_raytracer_tpu_torch.kernels import fused_shade as fs
    scene, cam, cfg, calls = _frame(name)
    scene, cam = scene.to(card), cam.to(card)
    spans.counts.clear()
    got = render_linear(scene, cam, cfg, 7)
    assert spans.counts["fused_shade"] == calls * cfg.max_depth
    monkeypatch.setattr(fs, "use_kernel", lambda *a, **k: False)
    want = render_linear(scene, cam, cfg, 7)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("how", ["nee", "threefry", "autograd", "interpret"])
def test_shade_kernel_stays_off_its_routes(card, how):
    # NEE, threefry keys, a render that records autograd and interpret mode
    # take the PyTorch route: no launch.
    import dataclasses
    from qt_raytracer_tpu_torch.kernels import fused_shade as fs
    cfg = RenderConfig(width=24, height=16, spp=2, max_depth=4, rng="hash",
                       nee=how == "nee",
                       intersector="fused_diff" if how == "autograd"
                       else "fused_interpret" if how == "interpret"
                       else "fused")
    if how == "threefry":
        cfg = dataclasses.replace(cfg, rng="threefry")
    scene, cam = scenes.get_scene("cornell", cfg.aspect_ratio, device=card)
    if how == "autograd":
        scene = dataclasses.replace(
            scene, albedo=scene.albedo.clone().requires_grad_(True))
    spans.counts.clear()
    img = render_linear(scene, cam, cfg, 3)
    assert spans.counts["fused_shade"] == 0
    if how == "autograd":
        torch.autograd.grad(img.mean(), [scene.albedo])
    assert spans.counts["fused_shade"] == 0
