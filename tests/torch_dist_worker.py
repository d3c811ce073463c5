"""Ranks of a torch.distributed world on the CPU for the port's sharding
tests (``tests/test_torch_parallel.py``, ``tests/test_torch_distributed.py``):
the counterpart of ``tests/distributed_worker.py``, run through
``torch.multiprocessing`` spawn.

Spawned children re-import this module, so it imports no JAX (a child
would load JAX without ``tests/conftest.py``'s settings). Each child pins
PyTorch to one thread, joins a gloo group through a ``file://`` store under
the test's temporary directory (no TCP port for parallel test workers to
race for), runs one job of ``JOBS`` and saves its results for the parent.
``run_world`` joins the children with a timeout, so a rank that hangs fails
the test within it.
"""

from __future__ import annotations

import dataclasses
import datetime
import pathlib
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from qt_raytracer_tpu_torch import RenderConfig, render_linear, scenes
from qt_raytracer_tpu_torch.diff import inverse as inv
from qt_raytracer_tpu_torch.diff import multiview as mv
from qt_raytracer_tpu_torch.models import meshes
from qt_raytracer_tpu_torch.parallel import distributed, sharding

JOIN_TIMEOUT_S = 150
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# Sizes, as tests/test_parallel.py and tests/distributed_worker.py take them.
SPHERES = dict(width=16, height=12, spp=4, max_depth=4)
RAGGED = dict(width=15, height=11, spp=4, max_depth=4)
# Over px = 2 a rank's 83 pixels go in a chunk of 50 and one of 33, which
# accumulate_pixels pads to 50.
RAGGED_CHUNK = 50
ICOSPHERE = dict(width=16, height=12, spp=2, max_depth=3)
# The terrain at JAX's image size over a 32 x 32 cell grid (1,922
# triangles, 4 clusters) in place of the full 224 x 224 grid: that one's
# single-process reference alone takes some 230 s on one CPU core.
TERRAIN = dict(width=96, height=54, spp=2, max_depth=3, rng="hash")
TERRAIN_CELLS = 32
GRAD = dict(width=16, height=12, spp=4, max_depth=3)
TINY_GRAD = dict(width=8, height=6, spp=2, max_depth=2, intersector="xla")
STEP = dict(width=16, height=12, spp=2, max_depth=3, rng="hash")
STEP_KEY = 11
TARGET_KEY = 9
LR = 5e-2
VIEWS = ((0.0, 0.0, 0.0), (0.3, 0.0, 0.0))


def three_sphere(cfg: RenderConfig, device="cpu"):
    return scenes.get_scene("three_sphere", cfg.aspect_ratio, device=device)


def icosphere(cfg: RenderConfig, device="cpu"):
    return (meshes.icosphere_world(subdiv=1, builder="numpy", device=device),
            meshes.icosphere_camera(cfg.aspect_ratio, device=device))


def terrain(cfg: RenderConfig, device="cpu"):
    return (meshes.terrain_world(TERRAIN_CELLS, TERRAIN_CELLS,
                                 builder="numpy", device=device),
            meshes.terrain_camera(cfg.aspect_ratio, device=device))


def wrong_scene(scene):
    """The three-sphere scene with sphere 1's albedo and emission off, the
    start of the train-step cases."""
    albedo = scene.albedo.clone()
    albedo[1] = torch.tensor([0.2, 0.6, 0.8])
    emission = scene.emission.clone()
    emission[2] = 0.5
    return dataclasses.replace(scene, albedo=albedo, emission=emission)


def grad_albedo(scene, cam, cfg, mesh=None):
    """(image, d mean(image^2) / d albedo) of the render, sharded over mesh
    when one is given."""
    cfg = inv.grad_capable_config(cfg)
    albedo = scene.albedo.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, albedo=albedo)
    img = render_linear(sc, cam, cfg, 0) if mesh is None else \
        sharding.render_linear_sharded(sc, cam, cfg, 0, mesh)
    g, = torch.autograd.grad(torch.mean(img ** 2), albedo)
    return img.detach(), g


def step_cases():
    """name -> (builder of (init, step, rebuild...), targets, steps): the
    train-step cases, each built by the same code on one process and on the
    ranks (mesh=None there means one process)."""
    cfg = RenderConfig(**STEP)
    scene, cam = three_sphere(cfg)
    start = wrong_scene(scene)
    cams = mv.orbit_cameras(cam, VIEWS)
    with torch.no_grad():
        target = inv.mean_image(scene, cam, cfg, TARGET_KEY)
        targets = torch.stack([inv.mean_image(scene, c, cfg, TARGET_KEY + v)
                               for v, c in enumerate(cams)])
    opt = inv.adam(LR)
    single = dict(trainable=("albedo", "emission"), train_camera="pose")
    return {
        "l2": (lambda mesh: inv.make_train_step(
            start, cam, cfg, opt, **single, mesh=mesh), target, 2),
        "dual": (lambda mesh: inv.make_train_step(
            start, cam, cfg, opt, **single, mesh=mesh, loss="dual"),
            target, 1),
        "edge_aware": (lambda mesh: inv.make_train_step(
            start, cam, cfg, opt, **single, mesh=mesh, edge_aware=True),
            target, 1),
        "multiview": (lambda mesh: mv.make_multiview_train_step(
            start, cams, cfg, opt, mesh=mesh), targets, 1),
        "multiview_perview": (lambda mesh: mv.make_multiview_train_step_perview(
            start, cams, cfg, opt, mesh=mesh), targets, 1),
    }


def run_steps(make, target, steps, mesh=None) -> dict:
    """Losses and final parameters (by leaf path) of `steps` steps."""
    init, step, _, _ = make(mesh)
    state, losses = init(), []
    for _ in range(steps):
        state, loss = step(state, target, STEP_KEY)
        losses.append(loss)
    return {"losses": torch.stack(losses),
            "params": {p: t.detach().clone()
                       for p, t in inv.leaves(state.params)}}


# Jobs: each runs on every rank of its world and returns what the parent
# checks.


def job_render(rank: int, world: int) -> dict:
    """The sharded renders of tests/test_parallel.py at every mesh shape of
    this world, plus (world 2) the refusals and replicate."""
    out = {}
    cfg = RenderConfig(**SPHERES)
    scene, cam = three_sphere(cfg)
    shapes = [(1, world), (world, 1)] + ([(2, 2)] if world == 4 else [])
    for sp, px in shapes:
        mesh = sharding.make_mesh(sp=sp, px=px)
        out[f"spheres_{sp}x{px}"] = sharding.render_linear_sharded(
            scene, cam, cfg, 0, mesh)
    if world == 4:
        icfg = RenderConfig(**ICOSPHERE)
        out["icosphere_2x2"] = sharding.render_linear_sharded(
            *icosphere(icfg), icfg, 0, sharding.make_mesh(sp=2))
        tcfg = RenderConfig(**TERRAIN)
        out["terrain_1x4"] = sharding.render_linear_sharded(
            *terrain(tcfg), tcfg, 0, sharding.make_mesh(sp=1))
        return out
    rcfg = RenderConfig(**RAGGED)
    out["ragged_1x2"] = sharding.render_linear_sharded(
        scene, cam, rcfg, 0, sharding.make_mesh(sp=1))
    out["chunked_1x2"] = sharding.render_linear_sharded(
        scene, cam, dataclasses.replace(rcfg, pixel_chunk=RAGGED_CHUNK), 0,
        sharding.make_mesh(sp=1))
    for what, call in (
            ("spp", lambda: sharding.render_linear_sharded(
                scene, cam, dataclasses.replace(cfg, spp=3), 0,
                sharding.make_mesh(sp=2))),
            ("mesh", lambda: sharding.make_mesh(sp=3))):
        try:
            call()
            out[f"raised_{what}"] = ""
        except ValueError as e:
            out[f"raised_{what}"] = str(e)
    # Still in step after the refusals: a collective completes.
    ones = torch.ones(1)
    dist.all_reduce(ones)
    out["after_refusals"] = ones
    # replicate: rank 0's scene and camera reach every rank.
    mesh = sharding.make_mesh()
    mine = scene if rank == 0 else dataclasses.replace(
        scene, albedo=torch.zeros_like(scene.albedo),
        active=torch.zeros_like(scene.active))
    rep = sharding.replicate({"scene": mine, "camera": cam}, mesh)
    out["replicated_albedo"] = rep["scene"].albedo
    out["replicated_active"] = rep["scene"].active
    return out


def job_train(rank: int, world: int) -> dict:
    """The two-process render and gradient of tests/distributed_worker.py,
    the train steps with mesh=, and the distributed helpers."""
    out = {}
    cfg = RenderConfig(**GRAD)
    scene, cam = three_sphere(cfg)
    for sp in (2, 1):
        img, g = grad_albedo(scene, cam, cfg, distributed.global_mesh(sp=sp))
        out[f"grad_image_sp{sp}"], out[f"grad_albedo_sp{sp}"] = img, g
    tcfg = RenderConfig(**TINY_GRAD)
    _, out["tiny_grad_albedo"] = grad_albedo(*three_sphere(tcfg), tcfg,
                                             distributed.global_mesh(sp=2))
    cases = step_cases()
    for sp in (2, 1):
        make, target, steps = cases["l2"]
        out[f"l2_sp{sp}"] = run_steps(make, target, steps,
                                      sharding.make_mesh(sp=sp))
    for name in ("dual", "edge_aware", "multiview", "multiview_perview"):
        make, target, steps = cases[name]
        out[name] = run_steps(make, target, steps, sharding.make_mesh(sp=1))
    out["global_mesh"] = [distributed.global_mesh(sp=s).shape for s in (1, 2)]
    out["is_coordinator"] = distributed.is_coordinator()
    img = out["grad_image_sp1"]
    out["gathered"] = torch.from_numpy(distributed.gather_image(img))
    return out


JOBS = {"render": job_render, "train": job_train}


def _entry(rank: int, world: int, job: str, tmp: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize(f"file://{tmp}/store", world, rank, device="cpu",
                           timeout=GROUP_TIMEOUT)
    try:
        t0 = time.perf_counter()
        out = JOBS[job](rank, world)
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, pathlib.Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(world: int, job: str, tmp: pathlib.Path) -> list[dict]:
    """Run `job` on `world` spawned gloo ranks; each rank's results."""
    ctx = mp.start_processes(_entry, args=(world, job, str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of job {job!r} did not "
                                   f"finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
