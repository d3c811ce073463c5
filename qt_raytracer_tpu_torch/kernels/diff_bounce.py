"""One differentiable sphere bounce in CUDA: the wrapper, its
``torch.autograd.Function`` and its route.

``integrator_flat.bounce(diff=True)`` selects each ray's winner with the
shadow-mode sweep (A2), then re-derives the hit from the scene's parameter
table and shades it in PyTorch ops (``_rederive_hits_flat``,
``_emit_weight_flat``, ``_shade_plain`` with ``_nee_flat``), some 760 kernel
launches forward and 800 in autograd's backward a bounce on the card. Here
the same bounce after A2's selection is ``csrc/diff_bounce.cu``:

- forward, kernel F1 (counted ``diff_bounce[shadow_rays]``, with NEE only)
  re-derives the hit and writes NEE's shadow rays; A2 traces them; kernel
  F2 (``diff_bounce``) does the rest of the bounce and writes the new
  carry. Every output lane equals the PyTorch route bit for bit, dead lanes
  included;
- backward, kernel B (``diff_bounce[backward]``) recomputes the forward in
  registers and writes the carry's gradients and the parameter table's,
  the pathwise derivatives with every decision held fixed that autograd
  takes through the route's ``torch.where``. Two calls on the same inputs
  give the same bits.

It replaces no TPU kernel (the JAX package differentiates this step with
XLA's fusions). The plain version is that PyTorch route, unchanged: it
serves CPU tensors, interpret mode, threefry keys and mesh worlds, and the
card tests hold the kernels to it.

``use_kernel`` is the route rule, read from the inputs alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.sampling import STREAM_BOUNCE0
from ..runtime import cuda_build
from .fused_hit import FusedSpheres, fused_hit

# The per-lane operands in the kernels' order (csrc/diff_bounce.cu: Op,
# OpOther); an operand a kernel does not read is a null pointer.
OPERANDS = ("ox", "oy", "oz", "dx", "dy", "dz", "tx", "ty", "tz", "rx", "ry",
            "rz", "prev_pdf", "t_sel", "sh_t", "alive", "keys", "idx",
            "sh_idx")
DTYPES = ((torch.float32,) * 15 + (torch.bool, torch.int64, torch.int32,
                                   torch.int32))
CARRY = OPERANDS[:13]      # the differentiable carry, F2's [13, N] rows
GRADS = 10                 # B's [10, N] rows: ox..dz, tx..tz, prev_pdf
BLOCK = 256                # the kernels' threads a block
BLOCKS_PER_SM = 2          # the backward's bounded grid
# Parameter rows B's shared memory holds: (12 + 1) * 4 bytes a row beside
# the 26,624 bytes of a tile's records, within an H100 block's 227 KB.
MAX_SLOTS = 3072


def use_kernel(device: torch.device, interpret: bool, keys: torch.Tensor,
               tables) -> bool:
    """True when ``bounce(diff=True)`` takes the kernels: tensors on a CUDA
    device, not interpret, hash states ([N] keys, not [N, 2] threefry
    keys), and a sphere scene's tables (FusedSpheres, not a mesh world's)
    of at most MAX_SLOTS rows. NEE and autograd recording may be on or
    off. Like ``fused_shade.use_kernel`` it returns False, never raises, on
    any other device: the PyTorch route serves every case the kernels do
    not take."""
    return (device.type == "cuda" and not interpret and keys.dim() == 1
            and isinstance(tables, FusedSpheres)
            and tables.params.shape[0] <= MAX_SLOTS)


def diff_bounce(tables: FusedSpheres, s, sel: dict, depth_idx: int,
                t_min: float, rr_start: int, light_idx) -> tuple:
    """The bounce after A2's selection sel ({"t", "idx"}): s, the ray state
    (a RayState on a CUDA device, hash keys); light_idx, the scene's [L]
    light ids for NEE, or None. Returns (ox, oy, oz, dx, dy, dz, tx, ty, tz,
    rx, ry, rz, prev_pdf, alive), differentiable in the carry and in
    tables.params wherever autograd records. Raises on operands the kernels
    do not take; it never falls back."""
    setup = _Setup(tables, s.alive, s.keys, sel["idx"], sel["t"],
                   _lights(light_idx, s.ox.device),
                   STREAM_BOUNCE0 + int(depth_idx),
                   int(rr_start > 0 and depth_idx >= rr_start), float(t_min))
    return _DiffBounce.apply(setup, tables.params,
                             *(getattr(s, k) for k in CARRY))


class _Setup:
    """The bounce's operands that carry no gradient."""

    def __init__(self, tables, alive, keys, idx, t_sel, lights, stream_id,
                 rr, t_min):
        self.tables, self.alive, self.keys = tables, alive, keys
        self.idx, self.t_sel, self.lights = idx, t_sel, lights
        self.stream_id, self.rr, self.t_min = stream_id, rr, t_min


class _DiffBounce(torch.autograd.Function):
    """F1, A2's shadow rays and F2 forward; B backward. Saved: the carry
    but the radiance, alive, keys, the selection and the shadow result,
    the parameter table and the light ids; B recomputes the rest."""

    @staticmethod
    def forward(ctx, st: _Setup, params, *carry):
        ops = {**dict(zip(CARRY, carry)), "t_sel": st.t_sel,
               "alive": st.alive, "keys": st.keys, "idx": st.idx}
        if st.lights.shape[0]:
            rays, cand = shadow_rays(st, params, ops)
            sh = fused_hit(st.tables, *rays.unbind(0), cand, st.t_min,
                           shadow_only=True)
            ops.update(sh_t=sh["t"], sh_idx=sh["idx"])
        out, alive = forward(st, params, ops)
        ctx.names = [*CARRY[:9], "prev_pdf", "t_sel", "alive", "keys", "idx",
                     *(["sh_t", "sh_idx"] if "sh_t" in ops else [])]
        ctx.save_for_backward(params, st.lights,
                              *(ops[k] for k in ctx.names))
        ctx.st = st.stream_id, st.rr, st.t_min
        ctx.mark_non_differentiable(alive)
        ctx.set_materialize_grads(False)
        return (*out.unbind(0), alive)

    @staticmethod
    def backward(ctx, *grads):
        params, lights, *saved = ctx.saved_tensors
        gout, gparams = backward(ctx.st, params, lights,
                                 dict(zip(ctx.names, saved)),
                                 grads[:len(CARRY)], ctx.needs_input_grad[1])
        g = gout.unbind(0)
        return (None, gparams, *g[:9], *grads[9:12], g[9])


def shadow_rays(st: _Setup, params, ops: dict) -> tuple:
    """Kernel F1: NEE's shadow rays ([6, N] f32: origin, direction) and
    cand ([N] bool), the lanes that cast one. ops: the per-lane operands by
    OPERANDS' names. Counts under "diff_bounce[shadow_rays]"."""
    n, dev = ops["ox"].shape[0], ops["ox"].device
    ptrs, _keep = cuda_build.pointers(
        "diff_bounce", [ops.get(k) for k in OPERANDS], DTYPES, n, dev)
    rays = torch.empty((6, n), dtype=torch.float32, device=dev)
    cand = torch.empty(n, dtype=torch.bool, device=dev)
    cuda_build.launch(
        "qtrt_diff_bounce_shadow", ptrs, len(OPERANDS), params.data_ptr(),
        st.lights.data_ptr(), st.lights.shape[0], st.stream_id, st.t_min, n,
        rays.data_ptr(), cand.data_ptr(), device=dev,
        counted=("diff_bounce[shadow_rays]",))
    return rays, cand


def forward(st: _Setup, params, ops: dict) -> tuple:
    """Kernel F2: the bounce's new carry ([13, N] f32, CARRY's rows) and
    alive ([N] bool). ops as shadow_rays', with sh_t and sh_idx under NEE.
    Counts under "diff_bounce"."""
    n, dev = ops["ox"].shape[0], ops["ox"].device
    ptrs, _keep = cuda_build.pointers(
        "diff_bounce", [ops.get(k) for k in OPERANDS], DTYPES, n, dev)
    out = torch.empty((len(CARRY), n), dtype=torch.float32, device=dev)
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    cuda_build.launch(
        "qtrt_diff_bounce", ptrs, len(OPERANDS), params.data_ptr(),
        st.lights.data_ptr(), st.lights.shape[0], st.stream_id, st.rr,
        st.t_min, n, out.data_ptr(), alive.data_ptr(), device=dev,
        counted=("diff_bounce",))
    return out, alive


def backward(st: tuple, params, lights, ops: dict, grads,
             want_params: bool) -> tuple:
    """Kernel B: the carry's gradients ([10, N] f32: ox..dz, tx..tz,
    prev_pdf) and, with want_params, the parameter table's ([S, 16] f32;
    else None). st: (stream_id, rr, t_min) of the bounce; ops: F2's
    operands but the radiance; grads: the upstream gradients of CARRY's
    rows ([N] f32 of any stride, or None for zero). Counts under
    "diff_bounce[backward]"."""
    stream_id, rr, t_min = st
    n, dev = ops["ox"].shape[0], ops["ox"].device
    ptrs, _keep = cuda_build.pointers(
        "diff_bounce", [ops.get(k) for k in OPERANDS], DTYPES, n, dev)
    gptrs = (ctypes.c_void_p * len(CARRY))()
    strides = (ctypes.c_longlong * len(CARRY))()
    for k, g in enumerate(grads):
        if g is None:
            continue
        if g.dtype != torch.float32 or g.shape != (n,) or g.device != dev:
            raise ValueError("diff_bounce's upstream gradients must be [N] "
                             "float32 tensors on the rays' device")
        gptrs[k], strides[k] = g.data_ptr(), g.stride(0)
    gout = torch.empty((GRADS, n), dtype=torch.float32, device=dev)
    slots = params.shape[0]
    grid = min(-(-n // BLOCK), BLOCKS_PER_SM * _sm_count(dev))
    partials = gparams = None
    if want_params:
        partials = torch.empty((grid, slots, 12), dtype=torch.float32,
                               device=dev)
        gparams = torch.empty((slots, 16), dtype=torch.float32, device=dev)
    cuda_build.launch(
        "qtrt_diff_bounce_backward", ptrs, len(OPERANDS), gptrs, strides,
        params.data_ptr(), lights.data_ptr(), lights.shape[0], slots,
        stream_id, rr, t_min, n, grid, gout.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if gparams is None else gparams.data_ptr(), device=dev,
        counted=("diff_bounce[backward]",))
    return gout, gparams


def _lights(light_idx, dev: torch.device) -> torch.Tensor:
    """The light ids as the kernels take them: [L] int32, empty without
    NEE."""
    if light_idx is None:
        return torch.empty(0, dtype=torch.int32, device=dev)
    return light_idx.to(device=dev, dtype=torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
