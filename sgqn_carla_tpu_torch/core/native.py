"""ctypes bindings of the host-I/O library (`native/hostio.cpp`).

Counterpart of `sgqn_carla_tpu/core/native.py`, with the same entry points
and fallbacks: `png_write_batch` (threaded PNG encoder), `resize_bilinear`
and `synth_pool` (the procedural overlay pool). The library is built at
first use from `native/hostio.cpp` with `native/build.sh`'s g++ flags into
`build/hostio/` (once per source content; nothing is written under
`native/`). Where it cannot be built or loaded, every entry point falls
back as the JAX module's does: `png_write_batch` returns False (the caller
writes in pure Python), `resize_bilinear` takes nearest samples and
`synth_pool` returns None. This is host code: no device sits behind it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "hostio.cpp")
_BUILD = os.path.join(_REPO, "build", "hostio")
# native/build.sh's flags
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_LIBS = ["-lz", "-pthread"]

_lib = None
_tried = False


def build() -> str:
    """Compile the library into build/hostio/ (once per source content)
    and return its path; raises where it cannot be built."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(
            GXX_FLAGS + GXX_LIBS).encode()).hexdigest()[:12]
    out = os.path.join(_BUILD, f"libhostio_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC, *GXX_LIBS],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    lib.png_encode_batch.restype = ctypes.c_int
    lib.png_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p]
    lib.resize_bilinear_u8.restype = None
    lib.resize_bilinear_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.synth_pool_u8.restype = None
    lib.synth_pool_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def png_write_batch(frames: np.ndarray, paths) -> bool:
    """Write (N, H, W, 3) uint8 frames to the PNG files `paths` in
    parallel. Returns False where the library is unavailable (the caller
    falls back)."""
    lib = _load()
    if lib is None:
        return False
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    if c != 3 or len(paths) != n:
        raise ValueError(f"frames (N, H, W, 3) and N paths, got "
                         f"{frames.shape} and {len(paths)} paths")
    blob = b"".join(p.encode() + b"\x00" for p in paths)
    return lib.png_encode_batch(frames.ctypes.data, n, w, h, blob) == 0


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W, C) uint8 bilinear resize (nearest samples without the
    library)."""
    lib = _load()
    sh, sw, c = img.shape
    if lib is None:
        yi = (np.arange(dh) * sh // dh).clip(0, sh - 1)
        xi = (np.arange(dw) * sw // dw).clip(0, sw - 1)
        return img[yi][:, xi]
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw, c), np.uint8)
    lib.resize_bilinear_u8(img.ctypes.data, sh, sw, c, out.ctypes.data, dh,
                           dw)
    return out


def synth_pool(n: int, h: int, w: int, seed: int = 0):
    """Procedural overlay pool (N, H, W, 3) uint8, multithreaded C++; None
    where the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n, h, w, 3), np.uint8)
    lib.synth_pool_u8(out.ctypes.data, n, h, w, seed & 0xFFFFFFFF)
    return out
