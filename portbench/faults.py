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

The CPU tests drive whole runs with each; ``calibrate.py`` reads the train
cell's numbers under them on the card.
"""

from __future__ import annotations

import torch

from .harness import port

ALTER = 1.1
FAULTS = ("unchanged", "half_batch", "altered")
FRAME_FAULTS = ("half_batch", "altered")


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

        def train_step(scene, camera, cfg):
            init, step, leaves_fn = base(scene, camera, cfg)

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
