"""The application layer (counterpart of ``qt_raytracer_tpu.app``):
progressive and checkpointed renders, preview, the interactive viewer,
stats, profiling hooks and the command line
(``python -m qt_raytracer_tpu_torch.app.cli``)."""
