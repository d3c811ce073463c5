"""The differentiable bounce's kernels (``kernels/diff_bounce.py``) against
the PyTorch route of ``integrator_flat.bounce(diff=True)``.

On the CPU: the route rule (the kernels only for CUDA tensors, outside
interpret, with hash states, on a sphere scene's tables), that the wrapper
refuses CPU tensors instead of falling back, and that a train step on the
CPU takes the PyTorch route and counts no launch.

On the card (marker ``cuda``, skipped without one; the module imports no
JAX, so run it there with ``python -m pytest --noconftest -p no:cacheprovider
-q tests/test_torch_diff_bounce.py``): on wavefronts of a scene of every
material with two lights, with NEE on and off, Russian roulette on and off,
the bounce-0 exclude, dead lanes and misses, on a 414,720-lane wavefront of
BASELINE config 5 and one of the book cover's 512-slot table, the kernels
and the PyTorch route (``_rederive_hits_flat`` and ``_shade_plain`` with
autograd) take the same inputs:

- the forward carry is bitwise equal on every lane;
- each input's gradient (the carry's and the parameter table's) is within
  1e-4 x the larger of its norm and the median input's norm of the route's
  float32 gradient, and no further from the route's float64 gradient than
  the float32 route is. The float64 route takes the float32 route's
  selections and shadow results and its forward values: every op's result
  and every Python constant rounded to float32 (``_AtF32Values``), its
  backward in float64. It is the derivative of the float32 program; a
  float64 forward would move both float32 gradients away from it by the
  same amount, and which of them lands nearer would be chance;
- two backward calls give the same bits;
- the launch counts read one F2 a bounce, one F1 with NEE, one B a
  backward.

And one config-5 step at 1080p gives the PyTorch route's loss bit for bit
and gradients within the float32 part of that rule.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from qt_raytracer_tpu_torch import RenderConfig, SceneBuilder, scenes
from qt_raytracer_tpu_torch.core import integrator_flat as itf
from qt_raytracer_tpu_torch.core import render, sampling
from qt_raytracer_tpu_torch.diff import inverse as inv
from qt_raytracer_tpu_torch.kernels import diff_bounce as db
from qt_raytracer_tpu_torch.kernels import fused_hit as fh
from qt_raytracer_tpu_torch.models import meshes
from qt_raytracer_tpu_torch.runtime import spans
from torch_helpers import _one_thread  # noqa: F401

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
COUNTS = ("diff_bounce", "diff_bounce[shadow_rays]", "diff_bounce[backward]")
T_MIN = 1e-3
REL_TOL = 1e-4
# BASELINE config 5 (chip_smoke.C5): one 1080p view, 2 spp, depth 4, NEE.
C5 = dict(width=1920, height=1080, spp=2, max_depth=4, rng="hash", nee=True,
          samples_per_batch=1)
CHUNK = 414_720                 # resolve_pixel_chunk at 1080p


def _mixed_scene(device):
    """Ground, 30 spheres of every material (Lambertian, metal at fuzz 0
    and above, dielectric at ior 1.5 and 2.4, a hollow one) and two sphere
    lights of unequal size, in 128 slots."""
    rng = np.random.default_rng(11)
    b = SceneBuilder()
    b.lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    for k in range(30):
        c = (rng.uniform(-6, 6), rng.uniform(0.2, 2.5), rng.uniform(-6, 6))
        r = rng.uniform(0.2, 0.8)
        kind = k % 5
        if kind == 0:
            b.lambertian(c, r, rng.random(3))
        elif kind == 1:
            b.metal(c, r, rng.random(3), 0.0 if k % 2 else rng.random())
        elif kind == 2:
            b.dielectric(c, r, 1.5 if k % 2 else 2.4)
        elif kind == 3:
            b.dielectric(c, -r if k == 3 else r, 1.5)
        else:
            b.lambertian(c, r, (0.8, 0.8, 0.8))
    b.emissive((0.0, 7.0, 0.0), 1.5, (6.0, 6.0, 6.0))
    b.emissive((4.0, 3.0, -3.0), 0.5, (12.0, 9.0, 5.0))
    return b.build(pad_to=128, device=device)


def _mixed_rays(n: int, seed: int, device):
    """n rays from near (0, 1.5, 10) toward the scene's box; those aimed
    above it miss."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 1.5, 10.0]) + rng.normal(scale=0.3, size=(n, 3))
    target = rng.uniform([-8.0, -1.0, -8.0], [8.0, 6.0, 8.0], (n, 3))
    d = target - o
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)
    return f(o), f(d)


def _camera_wavefront(scene, cam, cfg, lo: int, n: int, device):
    """Rays and hash keys of pixels [lo, lo + n) of sample 0 of cfg."""
    i, j, pix = render.pixel_grid(cfg, device=device)
    sl = slice(lo, lo + n)
    keys = sampling.sample_keys(sampling.pixel_states(5, pix[sl], cfg.rng), 0)
    o, d = render._camera_rays(cam, cfg, keys, i[sl], j[sl])
    return o, d, keys


def _state_at(scene, o, d, keys, depth: int, lights, rr_start: int,
              kill_seed: int):
    """(tables, the carry entering bounce `depth`), traced by the PyTorch
    route; then about 7% of the lanes, and one whole 256-lane block where
    there is one, are made dead."""
    tables = fh.prep_fused_spheres(scene)
    s = itf.initial_state(o, d, keys)
    with torch.no_grad():
        for k in range(depth):
            s = _plain(itf.bounce)(tables, s, k, T_MIN, rr_start, False,
                                   lights, True)
    rng = np.random.default_rng(kill_seed)
    n = s.ox.shape[0]
    kill = rng.random(n) < 0.07
    if n >= 1024:
        kill[512:768] = True
    kill = torch.from_numpy(kill).to(s.alive.device)
    return tables, s._replace(alive=s.alive & ~kill)


def _plain(fn):
    """fn with the kernels' route rule off: the PyTorch route."""
    def run(*args, **kwargs):
        keep = db.use_kernel
        db.use_kernel = lambda *a, **k: False
        try:
            return fn(*args, **kwargs)
        finally:
            db.use_kernel = keep
    return run


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.is_floating_point() else x


class _Replay:
    """Records integrator_flat.fused_hit's results, then hands them back in
    the same order: the float64 route takes the float32 route's
    selections and shadow results."""

    def __init__(self):
        self.calls, self.at = [], None
        self.real = itf.fused_hit

    def __call__(self, *args, **kwargs):
        if self.at is None:
            out = self.real(*args, **kwargs)
            self.calls.append(out)
            return out
        self.at += 1
        return self.calls[self.at - 1]


class _RoundF32(torch.autograd.Function):
    """A float64 value rounded to float32, differentiated as the
    identity."""

    @staticmethod
    def forward(ctx, x):
        return x.float().double()

    @staticmethod
    def backward(ctx, g):
        return g


class _SqrtF32(torch.autograd.Function):
    """sqrt rounded to float32, whose backward reads the rounded result
    (as autograd's sqrt reads its own)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x).float().double()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (2 * y)


class _ReciprocalF32(torch.autograd.Function):
    """reciprocal rounded to float32, its backward likewise."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(x).float().double()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return -g * (y * y)


class _AtF32Values(TorchFunctionMode):
    """Float64 ops at float32 values: Python float arguments and float64
    results rounded to float32, so the forward computes the float32
    route's values while autograd differentiates in float64, from those
    values (sqrt and reciprocal save their rounded results)."""

    ROUNDED = {torch.sqrt: _SqrtF32, torch.Tensor.sqrt: _SqrtF32,
               torch.reciprocal: _ReciprocalF32,
               torch.Tensor.reciprocal: _ReciprocalF32}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        f32 = lambda a: float(np.float32(a)) if type(a) is float else a
        if func in self.ROUNDED and args[0].dtype == torch.float64:
            return self.ROUNDED[func].apply(args[0])
        out = func(*map(f32, args), **{k: f32(v) for k, v in
                                       (kwargs or {}).items()})
        if isinstance(out, torch.Tensor) and out.dtype == torch.float64:
            return _RoundF32.apply(out)
        return out


def _weights(x: torch.Tensor, gen) -> torch.Tensor:
    """Seeded float32 upstream weights for output x, in x's dtype."""
    return torch.randn(x.shape, generator=gen).to(x.device, x.dtype)


def _bounce_grads(tables, s, depth, rr_start, lights, exclude, dtype, seed,
                  route):
    """(new RayState, gradients [params, *CARRY] of sum(w * outputs) with
    seeded weights w) of one bounce along route (itf.bounce or its plain
    form), the carry and the parameter table as leaves of dtype."""
    params = tables.params.detach().to(dtype).requires_grad_(True)
    carry = {k: getattr(s, k).detach().to(dtype).requires_grad_(True)
             for k in db.CARRY}
    tab = fh.FusedSpheres(tables.spheres, params, tables.boxes)
    if dtype == torch.float64:
        with _AtF32Values():
            out = route(tab, s._replace(**carry), depth, T_MIN, rr_start,
                        False, lights, True, exclude)
    else:
        out = route(tab, s._replace(**carry), depth, T_MIN, rr_start, False,
                    lights, True, exclude)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((_weights(x, gen) * x).sum() for x in (*out[:12], out[13]))
    grads = torch.autograd.grad(loss, [params, *carry.values()],
                                allow_unused=True)
    return out, [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, [params, *carry.values()])], loss


def check_bounce(tables, s, depth, rr_start, lights, exclude=None,
                 seed=0) -> dict:
    """The kernels against the PyTorch route on one bounce (the module's
    docstring). Returns the gradient errors, by input."""
    replay = _Replay()
    itf.fused_hit = replay
    try:
        want, g32, _ = _bounce_grads(tables, s, depth, rr_start, lights,
                                     exclude, torch.float32, seed,
                                     _plain(itf.bounce))
        replay.at = 0
        _, g64, _ = _bounce_grads(tables, s, depth, rr_start, lights,
                                  exclude, torch.float64, seed,
                                  _plain(itf.bounce))
    finally:
        itf.fused_hit = replay.real
    before = {k: spans.counts[k] for k in COUNTS}
    params = tables.params.detach().clone().requires_grad_(True)
    carry = {k: getattr(s, k).detach().clone().requires_grad_(True)
             for k in db.CARRY}
    tab = fh.FusedSpheres(tables.spheres, params, tables.boxes)
    got = itf.bounce(tab, s._replace(**carry), depth, T_MIN, rr_start, False,
                     lights, True, exclude)
    nee = lights is not None
    assert {k: spans.counts[k] - before[k] for k in COUNTS} == {
        "diff_bounce": 1, "diff_bounce[shadow_rays]": int(nee),
        "diff_bounce[backward]": 0}
    for name, a, b in zip(itf.RayState._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    gen = torch.Generator().manual_seed(seed)
    loss = sum((_weights(x, gen) * x).sum() for x in (*got[:12], got[13]))
    leaves = [params, *carry.values()]
    gk = torch.autograd.grad(loss, leaves, retain_graph=True,
                             allow_unused=True)
    again = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert spans.counts["diff_bounce[backward]"] == \
        before["diff_bounce[backward]"] + 2
    gk = [torch.zeros_like(x) if g is None else g for g, x in zip(gk, leaves)]
    again = [torch.zeros_like(x) if g is None else g
             for g, x in zip(again, leaves)]
    for a, b in zip(gk, again):
        assert torch.equal(_bits(a), _bits(b))
    norms = [float(g.double().norm()) for g in g32]
    med = float(np.median(norms))
    errs = {}
    for name, k, p32, p64, nrm in zip(["params", *db.CARRY], gk, g32, g64,
                                      norms):
        k, p32 = k.double(), p32.double()
        assert bool(torch.isfinite(k).all()), name
        err = float((k - p32).norm())
        near64 = float((k - p64).norm())
        far64 = float((p32 - p64).norm())
        errs[name] = (err / max(nrm, med), near64, far64)
        assert err <= REL_TOL * max(nrm, med), (name, err, nrm, med)
        assert near64 <= far64, (name, near64, far64)
    return errs


# ------------------------------------------------------------ on the CPU
def _route_tables(kind: str):
    if kind == "world":
        world = meshes.terrain_world(8, 8, device="cpu")
        return itf.prep_world(world)
    scene = scenes.cornell_box_spheres(device="cpu")
    tables = fh.prep_fused_spheres(scene)
    if kind == "too_many_slots":
        big = tables.params.new_zeros((db.MAX_SLOTS + 1, 16))
        tables = tables._replace(params=big)
    return tables


# (device, interpret, threefry keys, tables, expected route)
ROUTES = {
    "cuda_hash_spheres": (CUDA, False, False, "spheres", True),
    "cpu_tensors": (CPU, False, False, "spheres", False),
    "interpret": (CUDA, True, False, "spheres", False),
    "threefry_keys": (CUDA, False, True, "spheres", False),
    "mesh_world": (CUDA, False, False, "world", False),
    "too_many_slots": (CUDA, False, False, "too_many_slots", False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_rule(case):
    # The kernels only when every condition holds; the device is the value
    # bounce reads off the state, so a CUDA device is named here without a
    # card. NEE and autograd recording do not enter the rule.
    dev, interpret, threefry, kind, want = ROUTES[case]
    keys = torch.arange(6, dtype=torch.int64)
    if threefry:
        keys = torch.stack([keys, keys], 1)
    assert db.use_kernel(dev, interpret, keys, _route_tables(kind)) is want


def test_wrapper_refuses_cpu_tensors():
    # A CPU tensor never reaches the kernels, and the wrapper does not fall
    # back to the PyTorch route either.
    scene = scenes.cornell_box_spheres(device="cpu")
    o, d = _mixed_rays(64, 0, "cpu")
    keys = torch.arange(64, dtype=torch.int64)
    tables = fh.prep_fused_spheres(scene)
    s = itf.initial_state(o, d, keys)
    sel = fh.fused_hit(tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, s.alive,
                       T_MIN, shadow_only=True)
    before = {k: spans.counts[k] for k in COUNTS}
    for lights in (None, scene.light_idx):
        with pytest.raises(ValueError, match="cuda"):
            db.diff_bounce(tables, s, sel, 0, T_MIN, 0, lights)
    assert {k: spans.counts[k] for k in COUNTS} == before


@pytest.mark.parametrize("edge_aware", [False, True])
def test_cpu_step_counts_no_launch(edge_aware):
    # A config-5 train step on CPU tensors takes the PyTorch route: finite
    # gradients, and no diff_bounce launch counted.
    cfg = RenderConfig(width=16, height=9, spp=2, max_depth=4, rng="hash",
                       nee=True, samples_per_batch=1, edge_aware=edge_aware)
    scene = scenes.cornell_box_spheres(device="cpu")
    cam = scenes.cornell_box_camera(cfg.aspect_ratio, device="cpu")
    target = torch.zeros((cfg.height, cfg.width, 3))
    init, step, _, _ = inv.make_train_step(
        scene, cam, cfg, inv.adam(0.01), trainable=("albedo", "emission"),
        train_camera="pose", edge_aware=edge_aware)
    spans.counts.clear()
    state, loss = step(init(), target, 3)
    assert all(spans.counts[k] == 0 for k in COUNTS)
    assert bool(torch.isfinite(loss))
    for _, t in inv.leaves(state.params):
        assert bool(torch.isfinite(t).all())


# ------------------------------------------------------------ on the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# (NEE, rr_start, depth, exclude at bounce 0)
BOUNCES = {
    "nee_depth0": (True, 0, 0, False),
    "nee_depth0_exclude": (True, 0, 0, True),
    "nee_depth2": (True, 0, 2, False),
    "nee_roulette": (True, 1, 2, False),
    "plain_depth1": (False, 0, 1, False),
    "plain_roulette": (False, 1, 3, False),
    "plain_depth0_exclude": (False, 0, 0, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1023, 20000])
@pytest.mark.parametrize("case", sorted(BOUNCES))
def test_mixed_scene_bounce(card, case, n):
    nee, rr_start, depth, excl = BOUNCES[case]
    scene = _mixed_scene(card)
    o, d = _mixed_rays(n, seed=n + depth, device=card)
    keys = sampling.hash_pixel_states(9, torch.arange(n, device=card))
    lights = scene.light_idx if nee else None
    tables, s = _state_at(scene, o, d, keys, depth, lights, rr_start,
                          kill_seed=n)
    exclude = None
    if excl:
        # Each lane leaves out its own winner (misses exclude -1).
        sel = fh.fused_hit(tables, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz,
                           s.alive, T_MIN, shadow_only=True)
        exclude = torch.where(sel["t"] < fh.BIG, sel["idx"], -1)
    check_bounce(tables, s, depth, rr_start, lights, exclude, seed=depth)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_config5_wavefront(card, depth):
    # Chunk 2 of BASELINE config 5's 1080p frame, 414,720 lanes.
    cfg = RenderConfig(**C5)
    scene = scenes.cornell_box_spheres(device=card)
    cam = scenes.cornell_box_camera(cfg.aspect_ratio, device=card)
    o, d, keys = _camera_wavefront(scene, cam, cfg, 2 * CHUNK, CHUNK, card)
    tables, s = _state_at(scene, o, d, keys, depth, scene.light_idx, 0,
                          kill_seed=depth)
    check_bounce(tables, s, depth, 0, scene.light_idx, seed=depth)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
def test_book_cover_wavefront(card, depth):
    # The book cover's 512-slot table, 414,720 lanes of its 1080p frame;
    # it has no light, so no NEE; roulette from bounce 2.
    cfg = RenderConfig(width=1920, height=1080, spp=1, max_depth=10,
                       rng="hash")
    scene, cam = scenes.get_scene("random", cfg.aspect_ratio, device=card)
    assert scene.num_spheres == 512
    o, d, keys = _camera_wavefront(scene, cam, cfg, CHUNK, CHUNK, card)
    tables, s = _state_at(scene, o, d, keys, depth, None, 2,
                          kill_seed=depth)
    check_bounce(tables, s, depth, 2, None, seed=depth)


def _c5_view(scene, cam, cfg, target, key):
    """The config-5 loss of one view and its gradients by leaf (albedo,
    emission, the camera's translation), as a train step takes them."""
    params = {"albedo": scene.albedo.clone().requires_grad_(True),
              "emission": scene.emission.clone().requires_grad_(True),
              "translate": torch.zeros(3, device=target.device,
                                       requires_grad=True)}
    sc = dataclasses.replace(scene, albedo=params["albedo"],
                             emission=params["emission"])
    camera = inv.translate_camera(cam, params["translate"])
    loss = inv.image_loss(sc, camera, inv.grad_capable_config(cfg), key,
                          target)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


def check_step(device, cfg, units: int) -> None:
    """One config-5 view step under cfg on device: the PyTorch route's loss
    bit for bit, its gradients within the rule's float32 part, and the
    launches of `units` (chunk, sample) units of max_depth bounces: F1 and
    F2 twice (forward and the recompute), B once."""
    scene = scenes.cornell_box_spheres(device=device)
    cam = scenes.cornell_box_camera(cfg.aspect_ratio, device=device)
    with torch.no_grad():
        target = inv.mean_image(scene, cam, dataclasses.replace(
            cfg, edge_aware=False), sampling.prng_key(7, device))
    start = dataclasses.replace(
        scene, albedo=scene.albedo * 0.8, emission=scene.emission * 0.7)
    key = sampling.prng_key(3, device)
    spans.counts.clear()
    loss, grads = _c5_view(start, cam, cfg, target, key)
    assert {k: spans.counts[k] for k in COUNTS} == {
        "diff_bounce": 2 * units * cfg.max_depth,
        "diff_bounce[shadow_rays]": 2 * units * cfg.max_depth,
        "diff_bounce[backward]": units * cfg.max_depth}
    want_loss, want = _plain(_c5_view)(start, cam, cfg, target, key)
    assert torch.equal(_bits(loss), _bits(want_loss))
    norms = [float(g.double().norm()) for g in want]
    med = float(np.median(norms))
    for g, w, nrm in zip(grads, want, norms):
        assert bool(torch.isfinite(g).all())
        assert float((g.double() - w.double()).norm()) <= \
            REL_TOL * max(nrm, med)


@pytest.mark.cuda
@pytest.mark.parametrize("edge_aware", [False, True])
def test_config5_step_at_1080p(card, edge_aware):
    # Pathwise, and edge-aware: its l_full takes the kernels (its
    # background re-trace and forward-mode pass stay outside them).
    cfg = RenderConfig(**C5, edge_aware=edge_aware)
    check_step(card, cfg, units=5 * cfg.spp)
