"""The system under test: the port (qt_raytracer_tpu_torch), built from the
benchmark's inputs through its public constructors, and its two entries,
``render_linear`` and the train step of ``diff.inverse.make_train_step``,
the latter also sharded over a mesh of ranks (``parallel.distributed``,
``parallel.sharding``). Everything the port derives (slot order, padding,
BVH, clusters, tables) stays inside it."""

from __future__ import annotations

import datetime

import torch

# A rank that does not arrive, or a collective that does not complete,
# fails after this many seconds.
GROUP_TIMEOUT_S = 120


def render_config(cfg: dict):
    from qt_raytracer_tpu_torch import RenderConfig

    return RenderConfig(**cfg["render"])


def build_scene(inputs: dict, cfg: dict, device):
    """The port's SphereScene, or its World when the inputs hold a mesh."""
    from qt_raytracer_tpu_torch import SceneBuilder, World, build_mesh

    sp = inputs["spheres"]
    b = SceneBuilder()
    for i in range(sp["radius"].shape[0]):
        b.add_sphere(tuple(float(x) for x in sp["center"][i]),
                     float(sp["radius"][i]), int(sp["mat"][i]),
                     albedo=tuple(float(x) for x in sp["albedo"][i]),
                     fuzz=float(sp["fuzz"][i]), ior=float(sp["ior"][i]),
                     emission=tuple(float(x) for x in sp["emission"][i]))
    spheres = b.build(pad_to=int(cfg["scene"].get("pad_to", 128)),
                      device=device)
    me = inputs.get("mesh")
    if me is None:
        return spheres
    builder = cfg["scene"]["builder"]
    mesh = build_mesh(me["vertices"], me["faces"], mat_type=me["mat"],
                      albedo=me["albedo"], fuzz=me["fuzz"], ior=me["ior"],
                      emission=me["emission"], builder=builder,
                      device=device)
    from qt_raytracer_tpu_torch.accel import mesh as mesh_mod

    if mesh_mod.last_builder != builder:
        raise RuntimeError(f"the BVH builder ran {mesh_mod.last_builder!r}, "
                           f"the configuration pins {builder!r}")
    return World(spheres=spheres, mesh=mesh)


def build_camera(cfg: dict, device, translate=None):
    from qt_raytracer_tpu_torch import make_camera
    from qt_raytracer_tpu_torch.diff.inverse import translate_camera

    cam = cfg["camera"]
    r = cfg["render"]
    c = make_camera(cam["lookfrom"], cam["lookat"], cam["vup"],
                    float(cam["vfov"]), r["width"] / r["height"],
                    float(cam["aperture"]), float(cam["focus_dist"]),
                    device=device)
    if translate is not None:
        c = translate_camera(c, torch.tensor(translate, dtype=torch.float32,
                                             device=device))
    return c


def render_linear():
    from qt_raytracer_tpu_torch import render_linear as fn

    return fn


def train_step(scene, camera, cfg: dict, mesh=None):
    """(init_state, step_fn, leaves) of the port's train step for the
    configuration's "train" block; with a mesh (``make_mesh``) every render
    of the step is sharded over the ranks of the process group."""
    from qt_raytracer_tpu_torch.diff import inverse as inv

    tr = cfg["train"]
    init, step, _, _ = inv.make_train_step(
        scene, camera, render_config(cfg), inv.adam(dict(tr["lr"])),
        trainable=tuple(tr["trainable"]), train_camera=tr["train_camera"],
        mesh=mesh, edge_aware=bool(tr.get("edge_aware", False)),
        loss=tr.get("loss", "l2"))
    return init, step, inv.leaves


def mean_image(scene, camera, cfg: dict, key, mesh=None):
    from qt_raytracer_tpu_torch.diff import inverse as inv

    with torch.no_grad():
        return inv.mean_image(scene, camera, render_config(cfg), key, mesh)


def build_kernels() -> None:
    """Build the port's CUDA kernel library, which it otherwise builds on
    first use, so that the ranks started afterwards load it and none of
    them races another to build it."""
    from qt_raytracer_tpu_torch.runtime import cuda_build

    cuda_build.build()


def join_ranks(ranks: int, store: str, rank: int, device: str):
    """Join this process to a process group of `ranks` ranks through the
    file store `store`, as rank `rank` (NCCL on cuda:rank, gloo on the
    CPU), with a group timeout of GROUP_TIMEOUT_S; returns its device."""
    from qt_raytracer_tpu_torch.parallel import distributed

    return distributed.initialize(
        f"file://{store}", ranks, rank,
        device=None if device == "cuda" else device,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def make_mesh(sp: int, px: int):
    from qt_raytracer_tpu_torch.parallel.sharding import make_mesh as fn

    return fn(sp, px)
