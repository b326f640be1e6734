"""ctypes bindings for the native image runtime (port of
``spike2former_tpu/runtime``; its C++ source is the port's own copy,
``runtime/src/image_ops.cpp``): JPEG/PNG decode, bilinear and nearest
resize and float normalization in C++.

The library builds at first use with ``g++ -O3 -fPIC -shared ... -ljpeg
-lpng`` into ``<checkout>/build/runtime-<hash>/`` (git-ignored), keyed on
the source.  As in the JAX package, where it cannot build (no compiler or
no libjpeg/libpng headers) ``available()`` is False and every function
returns None; ``build_error()`` says why.  No pipeline of either package
calls it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "image_ops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpng")

_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_ROOT / f"runtime-{key.hexdigest()[:16]}" / "libs2f_runtime.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, lib)


def load() -> ctypes.CDLL | None:
    """The library, built if need be; None where it cannot be built."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    lib_path = library_path()
    try:
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = str(e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    intp = ctypes.POINTER(ctypes.c_int)
    lib.s2f_decode_image.restype = u8p
    lib.s2f_decode_image.argtypes = [ctypes.c_char_p, intp, intp, intp]
    lib.s2f_free.argtypes = [ctypes.c_void_p]
    lib.s2f_resize_bilinear_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int]
    lib.s2f_resize_nearest_i32.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int]
    lib.s2f_normalize_f32.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def build_error() -> str | None:
    """Why the library could not be built or loaded, if it could not."""
    load()
    return _error


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_image(path: str) -> np.ndarray | None:
    """Decode a JPEG or PNG into [H, W, C] uint8 (C = 3 for JPEG, the
    file's own for PNG); None without the library or where decoding
    fails."""
    lib = load()
    if lib is None:
        return None
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    buf = lib.s2f_decode_image(path.encode(), ctypes.byref(h),
                               ctypes.byref(w), ctypes.byref(c))
    if not buf:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
        return arr.reshape(h.value, w.value, c.value)
    finally:
        lib.s2f_free(buf)


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int
                       ) -> np.ndarray | None:
    """Half-pixel bilinear resize of [H, W, C] uint8 to [oh, ow, C]."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    lib.s2f_resize_bilinear_u8(_ptr(img, ctypes.c_uint8), h, w, c,
                               _ptr(out, ctypes.c_uint8), oh, ow)
    return out


def resize_nearest_i32(seg: np.ndarray, oh: int, ow: int
                       ) -> np.ndarray | None:
    """Nearest resize of an [H, W] int32 map to [oh, ow]."""
    lib = load()
    if lib is None:
        return None
    seg = np.ascontiguousarray(seg, np.int32)
    h, w = seg.shape
    out = np.empty((oh, ow), np.int32)
    lib.s2f_resize_nearest_i32(_ptr(seg, ctypes.c_int32), h, w,
                               _ptr(out, ctypes.c_int32), oh, ow)
    return out


def normalize_f32(img: np.ndarray, mean, std) -> np.ndarray | None:
    """``(img - mean) / std`` of [H, W, 3] uint8 as float32."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = np.empty((h, w, 3), np.float32)
    lib.s2f_normalize_f32(_ptr(img, ctypes.c_uint8), h, w,
                          _ptr(mean, ctypes.c_float),
                          _ptr(std, ctypes.c_float),
                          _ptr(out, ctypes.c_float))
    return out
