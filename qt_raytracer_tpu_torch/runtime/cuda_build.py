"""Build the port's CUDA kernels on first use and load them with ctypes.

``csrc/*.cu`` have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds. The library lands in ``qt_raytracer_tpu_torch/_build``
(listed in .gitignore), named after a hash of the sources and flags, so an
edited source or flag builds anew and an unchanged one is reused. Nothing is
built at import. Every failure raises: a missing ``nvcc``, a failed build or
a library that will not load leaves the caller nothing to carry on with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

# Route (b) of the port's build recipe. No --use_fast_math: the kernels'
# divides and square roots must stay IEEE-rounded.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqtrt_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the library unless it exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
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


def _configure(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # qtrt_fused_hit(ox, oy, oz, dx, dy, dz, alive, spheres, params,
    #                s, t_min, n, fout, iout, stream)
    lib.qtrt_fused_hit.restype = i
    lib.qtrt_fused_hit.argtypes = [p] * 9 + [i, f, i] + [p] * 3
