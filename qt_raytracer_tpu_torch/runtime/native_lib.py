"""ctypes loader of the repository's native runtime library,
``native/libqtrt_native.so`` (the C++ SAH BVH builder and OBJ loader), built on first use
with ``make -C native`` from the sources in the checkout.

Counterpart of ``qt_raytracer_tpu.runtime.native_lib``, with the same
meaning: ``load_native()`` returns None when the library cannot be built or
loaded, and the mesh builder then takes the numpy median builder (which
gives another triangle order; ``accel.mesh.last_builder`` says which ran).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "libqtrt_native.so"
_lock = threading.Lock()
_lib = None
_tried = False


def load_native():
    """The loaded CDLL, built if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not LIB_PATH.exists():
                subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                               capture_output=True, timeout=120)
            lib = ctypes.CDLL(str(LIB_PATH))
            _configure(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError, AttributeError):
            _lib = None
        return _lib


def _configure(lib) -> None:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int32)
    lib.qtrt_build_bvh.restype = ctypes.c_int
    lib.qtrt_build_bvh.argtypes = [
        c_float_p, c_float_p, ctypes.c_int, ctypes.c_int,
        c_float_p, c_float_p, c_int_p, c_int_p, c_int_p, c_int_p,
    ]
    lib.qtrt_obj_count.restype = ctypes.c_int
    lib.qtrt_obj_count.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
    lib.qtrt_obj_load.restype = ctypes.c_int
    lib.qtrt_obj_load.argtypes = [ctypes.c_char_p, c_float_p, c_int_p]
