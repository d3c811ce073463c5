"""Faults planted under the timed path, to show that the check sees them:
each patches the port's entry that the harness drives (``harness.port``)
or the train step's loss, and returns a function that undoes the patch.

  - "unchanged": a train step returns its state unchanged (the parameters
    are put back after the update);
  - "half_batch": half of the batch left out: a frame's lower half is not
    rendered; a train step's loss is the mean over the upper half alone;
  - "altered": an answer altered where it is produced: the rendered image
    (a frame, or the image in a step's loss) scaled by ALTER. (The train
    cell's numbers do not resolve a 1% alteration from the paths that
    float32 rounds apart; they resolve this one.)

Faults of the sharding layer, planted on the mesh's last rank, so that the
check must see past rank 0's own numbers:

  - "unsummed": that rank's gradients are not summed over the mesh (it
    joins the all-reduce, so no rank waits, and keeps its own part);
  - "dropped_range": that rank's pixel range is dropped from the image (it
    adds zeros to the all-reduce that assembles the image);
  - "crash" (``CRASH``, no fault of the numbers): that rank raises in its
    first render, for the test that a failed rank ends the run;
  - "loads_jax" (``LOADS_JAX``, no fault of the numbers): the check, which
    runs on rank 0 once the ranks have compared their modules, puts a
    stand-in ``jax`` module into ``sys.modules``, for the test that the
    run still refuses it.

The CPU tests drive whole runs with each; ``calibrate.py`` reads the train
cell's numbers under ``FAULTS`` on the card. A sharded cell's ranks each
plant the named fault in their own process (``plant_rank``).
"""

from __future__ import annotations

import sys
import types

import torch

from .harness import port

ALTER = 1.1
FAULTS = ("unchanged", "half_batch", "altered")
FRAME_FAULTS = ("half_batch", "altered")
SHARD_FAULTS = ("unsummed", "dropped_range")
CRASH = "crash"
LOADS_JAX = "loads_jax"


def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def plant_frame(fault: str):
    base = port.render_linear

    def render_linear():
        fn = base()

        def broken(scene, camera, cfg, key):
            img = fn(scene, camera, cfg, key)
            if fault == "half_batch":
                img = img.clone()
                img[img.shape[0] // 2:] = 0.0
                return img
            if fault == "altered":
                return img * ALTER
            raise ValueError(fault)
        return broken

    return _patch(port, "render_linear", render_linear)


def plant_train(fault: str):
    from qt_raytracer_tpu_torch.diff import inverse as inv

    if fault == "unchanged":
        base = port.train_step

        def train_step(scene, camera, cfg, mesh=None):
            init, step, leaves_fn = base(scene, camera, cfg, mesh)

            def broken(state, target, key):
                before = [p.detach().clone()
                          for _, p in leaves_fn(state.params)]
                new, loss = step(state, target, key)
                with torch.no_grad():
                    for (_, p), b in zip(leaves_fn(new.params), before):
                        p.copy_(b)
                return new, loss
            return init, broken, leaves_fn

        return _patch(port, "train_step", train_step)

    def image_loss(scene, camera, cfg, key, target, mesh=None):
        img = inv.mean_image(scene, camera, cfg, key, mesh)
        if fault == "half_batch":
            h = img.shape[0] // 2
            return torch.mean((img[:h] - target[:h]) ** 2)
        if fault == "altered":
            return torch.mean((img * ALTER - target) ** 2)
        raise ValueError(fault)

    return _patch(inv, "image_loss", image_loss)


def _victim(mesh) -> bool:
    return mesh.rank == mesh.size - 1


def plant_shard(fault: str):
    """A fault of ``parallel.sharding`` on the mesh's last rank: the
    sharded render's entry (gradients) or exit (image) broken there."""
    from qt_raytracer_tpu_torch.parallel import sharding

    if fault == "unsummed":
        base = sharding._ShareGrads

        class Unsummed(base):
            @staticmethod
            def backward(ctx, token_grad, *grads):
                out = base.backward(ctx, token_grad, *grads)
                return (None, *grads) if _victim(ctx.mesh) else out

        return _patch(sharding, "_ShareGrads", Unsummed)
    if fault not in ("dropped_range", CRASH):
        raise ValueError(fault)
    base = sharding._Assemble

    class Broken(base):
        @staticmethod
        def forward(ctx, partial, token, lo, n_padded, mesh):
            if _victim(mesh):
                if fault == CRASH:
                    raise RuntimeError(f"fault {CRASH!r} planted on rank "
                                       f"{mesh.rank}")
                partial = torch.zeros_like(partial)
            return base.forward(ctx, partial, token, lo, n_padded, mesh)

    return _patch(sharding, "_Assemble", Broken)


def plant_loads_jax():
    """The check's comparison loads a stand-in ``jax`` module."""
    from .harness import runner

    base = runner.compare_steps

    def compare_steps(got, ref):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return base(got, ref)

    return _patch(runner, "compare_steps", compare_steps)


def plant_rank(fault: str):
    """Plant a fault of this file by name in this process: a rank of a
    sharded cell plants the fault its run names."""
    if fault in FAULTS:
        return plant_train(fault)
    if fault == LOADS_JAX:
        return plant_loads_jax()
    return plant_shard(fault)
