"""The plain references that decide ``correct``: plain PyTorch from the
benchmark's own inputs, importing nothing of the port or of JAX.

A configuration names its reference by its optional "reference" key: the
module reference/<name>.py, found by ``harness.manifest.reference``;
without the key, ``train`` (the pathwise step on ``tracer``). Every
reference module has the frame interface, which the frame check, the
roofline wavefronts, the sharded target's check and ``calibrate.py`` read:

  - ``make_scene(inputs, dtype, device)``: the scene of
    ``harness.inputs.scene_inputs``;
  - ``make_camera(params, aspect, dtype, device, translate=None)``: the
    camera of the configuration's "camera" parameters;
  - ``render_pixels(scene, camera, settings, key, pixel, dtype,
    record=None)``: [N, 3] radiance of the N flat pixels `pixel`, summed
    over settings["spp"] samples, in `dtype`; `key` is [2] key words or
    [N, 2], one a pixel; ``record`` (a list) receives each bounce's
    wavefront ({"o", "d", "t_sphere", "t_hit"}), which the roofline rules
    count on.

A module that serves a train configuration also has
``steps(true_inputs, start_inputs, cfg, keys, tgt_key, dtype, device,
block, count)``: the first `count` steps from the starting point, returning
{"losses": [float] a step, "grad": {leaf: the first step's gradient},
"change": {leaf: parameters after the steps less before}}, the leaves
named as the port names them (``train.steps``).

``rng`` is no reference: it is the benchmark's random stream, which the
inputs and every reference share.
"""
