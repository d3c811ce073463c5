"""Build the port's CUDA kernels on first use and load them with ctypes.

``csrc/*.cu`` have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds: one ``nvcc -c`` per source, all started together,
then one link into a shared library. ``csrc/*.cuh`` are the headers they
share. The library lands in
``qt_raytracer_tpu_torch/_build`` (listed in .gitignore), named after a hash
of the sources and flags, so an edited source or flag builds anew and an
unchanged one is reused. Nothing is built at import. Every failure raises: a
missing ``nvcc``, a failed build or a library that will not load leaves the
caller nothing to carry on with. ``build_log`` keeps what ptxas reported
(registers, shared memory, spills) for the last build.

Every kernel wrapper reaches the library through this module: ``use_kernel``
is their route rule and ``launch`` their one launch, which counts each
launch in ``spans.counts``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from . import spans

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

# Route (b) of the port's build recipe. No --use_fast_math: the kernels'
# divides and square roots must stay IEEE-rounded.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib = None
build_log = ""


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under PyTorch's idea of CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, and no CUDA_HOME toolkit): the CUDA "
        "kernels of qt_raytracer_tpu_torch cannot be built")


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in (*_sources(), *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqtrt_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise on the first that fails.
    Returns their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    for cmd, proc in zip(cmds, procs):
        try:
            text, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, text)
    if failed:
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text}")
    return "".join(logs)


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the library unless it exists; return its path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    objs = [stem.with_name(f"{stem.name}.{src.stem}.o") for src in _sources()]
    tmp = stem.with_name(f"{stem.name}.tmp")
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(_sources(), objs)])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    build_log = log
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _configure(lib)
            _lib = lib
        return _lib


def use_kernel(device: torch.device, interpret: bool, what: str) -> bool:
    """The wrappers' route rule: False (the plain version) with interpret or
    on a CPU device, True (the kernel) on a CUDA device; any other device
    raises ValueError. A CUDA tensor never falls back to the plain version."""
    if interpret or device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {device}")
    return True


def launch(symbol: str, *args, device: torch.device, counted=()) -> None:
    """Launch the library's symbol on device with args and the device's
    current stream as its last argument. A nonzero cudaError_t raises
    RuntimeError and counts nothing; a launch adds 1 to spans.counts under
    each name in counted."""
    lib = load_library()
    with torch.cuda.device(device):
        err = getattr(lib, symbol)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    for name in counted:
        spans.counts[name] += 1


def _configure(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # excl is a device pointer, or None (a null pointer) for no operand.
    # qtrt_fused_hit(ox, oy, oz, dx, dy, dz, alive, excl, spheres, boxes,
    #                params, s, group, t_min, n, fout, iout, stream)
    lib.qtrt_fused_hit.restype = i
    lib.qtrt_fused_hit.argtypes = [p] * 11 + [i, i, f, i] + [p] * 3
    # qtrt_fused_hit_shadow(ox, oy, oz, dx, dy, dz, alive, excl, spheres,
    #                       boxes, s, group, t_min, n, t_out, idx_out, stream)
    lib.qtrt_fused_hit_shadow.restype = i
    lib.qtrt_fused_hit_shadow.argtypes = [p] * 10 + [i, i, f, i] + [p] * 3
    # qtrt_sphere_search(ox, oy, oz, dx, dy, dz, alive, excl, spheres, boxes,
    #                    s_pad, group, num_spheres, t_min, n, t_out, idx_out,
    #                    stream)
    lib.qtrt_sphere_search.restype = i
    lib.qtrt_sphere_search.argtypes = [p] * 10 + [i, i, i, f, i] + [p] * 3
    # qtrt_sphere_search_clustered(ox, oy, oz, dx, dy, dz, alive, spheres,
    #                              boxes, group, chunk_boxes, num_chunks,
    #                              k_stride, num_spheres, t_min, n, t_out,
    #                              idx_out, stream)
    lib.qtrt_sphere_search_clustered.restype = i
    lib.qtrt_sphere_search_clustered.argtypes = ([p] * 9 + [i, p, i, i, i, f,
                                                            i] + [p] * 3)
    # qtrt_mesh_first_cluster(ox, oy, oz, dx, dy, dz, alive, t_cap, boxes,
    #                         k, k_stride, groups, ng, t_min, n, out, out2,
    #                         stream)
    # out2 is a device pointer, or None for the first id alone.
    lib.qtrt_mesh_first_cluster.restype = i
    lib.qtrt_mesh_first_cluster.argtypes = ([p] * 9 + [i, i, p, i, f, i]
                                            + [p] * 3)
    # qtrt_mesh_search(ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris,
    #                  p_stride, rows, r_stride, boxes, k, k_stride, g, mode,
    #                  t_min, n, t_out, idx_out, stream)
    # rows is a device pointer, or None where the instance reads none.
    lib.qtrt_mesh_search.restype = i
    lib.qtrt_mesh_search.argtypes = ([p] * 10 + [i, p, i, p, i, i, i, i, f,
                                                 i] + [p] * 3)
    # qtrt_mesh_crossing_lists(ox, oy, oz, dx, dy, dz, alive, t_cap, boxes,
    #                          k, k_stride, groups, ng, t_min, n, c_max,
    #                          lists, ncross, stream)
    lib.qtrt_mesh_crossing_lists.restype = i
    lib.qtrt_mesh_crossing_lists.argtypes = ([p] * 9 + [i, i, p, i, f, i, i]
                                             + [p] * 3)
    # qtrt_mesh_pairs(ox, oy, oz, dx, dy, dz, t_cap, ray_buf, gmap, tris,
    #                 p_stride, rows, r_stride, g, t_min, n, b, t_out,
    #                 idx_out, stream)
    lib.qtrt_mesh_pairs.restype = i
    lib.qtrt_mesh_pairs.argtypes = [p] * 10 + [i, p, i, i, f, i, i] + [p] * 3
    # qtrt_bvh_walk(origins, directions, alive, excl, bmin, bmax, escape,
    #               start, count, m, v0, e1, e2, num_tris, max_leaf, t_min,
    #               t_max, n, t_out, idx_out, stream)
    lib.qtrt_bvh_walk.restype = i
    lib.qtrt_bvh_walk.argtypes = [p] * 9 + [i] + [p] * 3 + [i, i, f, f, i] \
        + [p] * 3
    # qtrt_fused_shade(ptrs, n_ptrs, stream_id, rr, emit_w, n, out,
    #                  alive_out, stream); ptrs is a host array of device
    # pointers.
    lib.qtrt_fused_shade.restype = i
    lib.qtrt_fused_shade.argtypes = [p, i, ctypes.c_uint, i, f, i] + [p] * 3
