"""Sharded rendering and training over torch.distributed ranks
(counterpart of ``qt_raytracer_tpu.parallel``)."""
