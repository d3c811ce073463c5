"""The one place the port picks a device.

Every entry point that creates tensors (scene, camera, mesh and world
constructors, the converters in ``utils.convert``) takes ``device=None`` and
resolves it here: ``None`` is the CUDA card, and raises when there is none;
``"cpu"`` (or any explicit device) is taken as given. Nothing falls back from
the card to the CPU: the CPU is used only when the caller asks for it, as the
tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to build tensors on: the current CUDA card for None, else
    ``torch.device(device)``. Raises RuntimeError when CUDA is needed and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: qt_raytracer_tpu_torch builds on the "
                "CUDA card unless the caller passes device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
