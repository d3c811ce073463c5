"""One bounce's shading in one CUDA kernel: the wrapper and its route.

``fused_shade`` launches ``csrc/fused_shade.cu`` ``shade_kernel``, which
runs the whole of ``core.integrator_flat._shade`` for a bounce without NEE
in one launch: the bounce's hash uniforms, the scatter of the four
materials, the sky and emission, Russian roulette and the continuing ray,
per ray lane in registers. It replaces no TPU kernel (the JAX package
leaves this glue to XLA's fusion); on the card the PyTorch route of the
same step issues some 240 kernels a bounce. Its plain version is that
route, ``integrator_flat._shade_plain``, and every output lane of the
kernel equals it bit for bit on the card, dead lanes included.

``use_kernel`` is the route rule, read from the inputs alone: the kernel
for CUDA tensors, outside interpret mode, with hash states for keys, no
NEE, and no autograd recording a tensor that requires grad. The NEE step
launches A2 and a mesh search mid-shading and the gradient path needs
autograd's graph, so both keep the PyTorch route.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.sampling import STREAM_BOUNCE0
from ..runtime import cuda_build

# The operands in the kernel's order (csrc/fused_shade.cu: In, Other).
STATE_FLOATS = ("ox", "oy", "oz", "dx", "dy", "dz", "tx", "ty", "tz",
                "rx", "ry", "rz")
HIT_FLOATS = ("t", "px", "py", "pz", "nx", "ny", "nz", "ax", "ay", "az",
              "fuzz", "ior", "ex", "ey", "ez")
HIT_INTS = ("mat", "ff")
DTYPES = ((torch.float32,) * (len(STATE_FLOATS) + len(HIT_FLOATS))
          + (torch.bool, torch.int64) + (torch.int32,) * len(HIT_INTS))


def use_kernel(device: torch.device, interpret: bool, keys: torch.Tensor,
               nee: bool, tensors) -> bool:
    """True when ``_shade`` launches the kernel: tensors on a CUDA device,
    not interpret, hash states ([N] keys, not [N, 2] threefry keys), no
    NEE, and autograd not recording any of tensors (the state's and the
    hit's) that requires grad. Unlike ``cuda_build.use_kernel``, the rule
    of the hit kernels, it returns False, never raises, on any other
    device: ``_shade_plain`` serves every device and every case the kernel
    does not take."""
    if device.type != "cuda" or interpret or keys.dim() != 1 or nee:
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors))


def fused_shade(s, h: dict, depth_idx: int, rr_start: int,
                emit_w: float = 1.0) -> tuple:
    """``_shade`` without NEE in one launch. s: the ray state (a RayState:
    ox..rz [N] f32, alive [N] bool, keys [N] int64 hash states); h: the hit
    dict of A1 or of the world merge (HIT_FLOATS [N] f32, mat and ff [N]
    i32). Returns the new (ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz,
    alive), none of them recorded by autograd; prev_pdf, keys and pid are
    unchanged without NEE. Raises on operands the kernel does not take; it
    never falls back. Each launch counts once under "fused_shade"."""
    ops = ([getattr(s, k) for k in STATE_FLOATS] + [h[k] for k in HIT_FLOATS]
           + [s.alive, s.keys] + [h[k] for k in HIT_INTS])
    n = s.ox.shape[0]
    dev = s.ox.device
    ptrs, _copies = _pointers(ops, n, dev)
    out = torch.empty((len(STATE_FLOATS), n), dtype=torch.float32, device=dev)
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    roulette = rr_start > 0 and depth_idx >= rr_start
    cuda_build.launch(
        "qtrt_fused_shade", ptrs, len(ops), STREAM_BOUNCE0 + int(depth_idx),
        int(roulette), float(emit_w), n, out.data_ptr(), alive.data_ptr(),
        device=dev, counted=("fused_shade",))
    return (*out.unbind(0), alive)


def _pointers(ops, n: int, dev: torch.device):
    """(ctypes array of the operands' device pointers, in the kernel's
    order; the contiguous copies made of strided operands, to be kept until
    the launch). Raises ValueError on a device, dtype or shape the kernel
    does not take. One pass over the operands: this runs on every bounce."""
    if dev.type != "cuda":
        raise ValueError(f"fused_shade runs on cuda tensors, got {dev}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"fused_shade takes 0 < N < 2^31 lanes, got {n}")
    ptrs = (ctypes.c_void_p * len(ops))()
    copies = []
    index = dev.index
    for k, (x, dtype) in enumerate(zip(ops, DTYPES)):
        if x.dtype is not dtype or x.shape != (n,) or \
                x.get_device() != index:
            raise ValueError("fused_shade operands must be [N] tensors on one "
                             "cuda device: f32 state and hit fields, bool "
                             "alive, int64 hash states, i32 mat and ff")
        if not x.is_contiguous():
            x = x.contiguous()
            copies.append(x)
        ptrs[k] = x.data_ptr()
    return ptrs, copies
